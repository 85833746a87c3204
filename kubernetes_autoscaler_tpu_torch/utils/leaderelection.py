"""Leader election: active/passive HA for the control loop.

Reference counterpart: main.go:271-319 — leaderelection.RunOrDie over a
kube Lease lock; only the leader runs the loop, replicas block. Standalone
equivalent: an OS-level advisory file lock (flock) with the same contract —
`run_or_die(fn)` blocks until leadership is acquired, runs fn, and releases
on exit. Works across processes on one host; multi-host deployments point
the lease file at shared storage or swap in a Lease-based implementation
behind the same interface.
"""

from __future__ import annotations

import fcntl
import os
import time


class FileLeaderElector:
    def __init__(self, lease_file: str, retry_period_s: float = 2.0):
        self.lease_file = lease_file
        self.retry_period_s = retry_period_s
        self._fd: int | None = None

    def try_acquire(self) -> bool:
        fd = os.open(self.lease_file, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return False
        os.ftruncate(fd, 0)
        os.write(fd, str(os.getpid()).encode())
        self._fd = fd
        return True

    def acquire(self, timeout_s: float | None = None, stop=None) -> bool:
        """Block for leadership. `stop` (threading.Event) aborts the wait —
        a passive replica must stay killable by SIGTERM while standing by."""
        deadline = None if timeout_s is None else time.time() + timeout_s
        while True:
            if stop is not None and stop.is_set():
                return False
            if self.try_acquire():
                return True
            if deadline is not None and time.time() >= deadline:
                return False
            if stop is not None:
                stop.wait(self.retry_period_s)
            else:
                time.sleep(self.retry_period_s)

    def release(self) -> None:
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None

    def is_leader(self) -> bool:
        return self._fd is not None

    def run_or_die(self, fn, timeout_s: float | None = None, stop=None):
        """reference: leaderelection.RunOrDie — block for leadership, run.
        Returns None without running fn when `stop` fires during the wait."""
        if not self.acquire(timeout_s, stop=stop):
            if stop is not None and stop.is_set():
                return None
            raise TimeoutError("could not acquire leadership")
        try:
            return fn()
        finally:
            self.release()

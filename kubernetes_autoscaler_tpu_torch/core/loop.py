"""Loop driver: ticks RunOnce, re-running immediately after productive loops.

Reference counterpart: loop/trigger.go:56 LoopTrigger (event-driven wakeup on
unschedulable-pod events, else scan-interval tick; immediate re-run after a
productive scale-up/scale-down) and loop/run.go:32 RunAutoscalerOnce (health
check + metrics wrapper — the loop SURVIVES a raising iteration; the
reference wraps every RunOnce so one bad loop never kills the process).

A raising `run_once()` here is recorded as a failed RunOnceStatus (ran=False,
`error` carries the exception) and the driver backs off exponentially between
retries — a persistently-broken backend costs bounded wall clock per retry
instead of a hot crash loop, and a recovered backend resumes on the next
tick. `PhaseDeadlineExceeded` from the backend supervisor's guards
(core/supervisor.py) lands here like any other error: the supervisor already
booked the incident; the driver's job is only to stay alive.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from kubernetes_autoscaler_tpu_torch.core.static_autoscaler import (
    RunOnceStatus,
    StaticAutoscaler,
)


@dataclass
class LoopTrigger:
    scan_interval_s: float = 10.0

    def __post_init__(self):
        self._event = threading.Event()

    def poke(self) -> None:
        """Unschedulable-pod observer hook (reference: UnschedulablePodObserver)."""
        self._event.set()

    def wait(self, last_productive: bool) -> None:
        """reference: LoopTrigger.Wait :75-103 — immediate re-run after a
        productive loop; otherwise wait for an event or the tick."""
        if last_productive:
            return
        self._event.wait(timeout=self.scan_interval_s)
        self._event.clear()


def run_loop(
    autoscaler: StaticAutoscaler,
    trigger: LoopTrigger | None = None,
    max_iterations: int | None = None,
    stop: threading.Event | None = None,
    error_backoff_initial_s: float = 1.0,
    error_backoff_max_s: float = 30.0,
) -> list[RunOnceStatus]:
    trigger = trigger or LoopTrigger(autoscaler.options.scan_interval_s)
    history: list[RunOnceStatus] = []
    productive = False
    consecutive_errors = 0
    i = 0
    while (max_iterations is None or i < max_iterations) and not (stop and stop.is_set()):
        trigger.wait(productive)
        try:
            status = autoscaler.run_once()
            consecutive_errors = 0
        except Exception as e:  # noqa: BLE001 — the driver must survive
            # (reference: loop/run.go recovers; run_once already marked the
            # health check failed and counted errors_total on its way out)
            consecutive_errors += 1
            status = RunOnceStatus(
                ran=False,
                aborted_reason=f"run_once raised: {type(e).__name__}",
                error=f"{type(e).__name__}: {e}",
                backend_state=autoscaler.supervisor.state
                if getattr(autoscaler, "supervisor", None) is not None
                else "",
                # an OOM-failed loop's device-memory pprof evidence
                # (static_autoscaler dumps it before the supervisor ladder
                # churns the heap)
                hbm_dump_path=getattr(autoscaler, "last_oom_dump", ""),
                # the most recent shadow-audit divergence bundle: a loop
                # that raises AFTER a divergence still points its failed
                # status at the evidence (the restart record carries the
                # same pointer across a crash)
                audit_bundle_path=getattr(
                    autoscaler, "last_audit_bundle", ""),
            )
            # exponent clamped: a backend down for hours must not overflow
            # float range inside the very handler that keeps the driver alive
            delay = min(
                error_backoff_initial_s
                * (2 ** min(consecutive_errors - 1, 20)),
                error_backoff_max_s)
            if delay > 0:
                # interruptible: a stop request mustn't wait out the backoff
                if stop is not None:
                    stop.wait(delay)
                else:
                    time.sleep(delay)
        history.append(status)
        productive = bool(
            status.ran
            and ((status.scale_up and status.scale_up.scaled_up)
                 or status.scale_down_deleted)
        )
        i += 1
    return history

"""Admission control for the multi-tenant sidecar: bounded queue, per-tenant
fairness, and the pipelined coalescing-window scheduler.

Three pieces (docs/SERVING.md):

  AdmissionQueue   a bounded, tenant-aware queue. `submit` raises QueueFull
                   (→ gRPC RESOURCE_EXHAUSTED + retry-after) once the depth
                   bound is hit — the service sheds load explicitly instead
                   of wedging behind an unbounded backlog. Window formation
                   is ROUND-ROBIN ACROSS TENANTS, not FIFO across all
                   requests: each cycle takes at most one ticket per tenant,
                   so a chatty tenant fills only the lanes quiet tenants
                   left unused and can never starve them
                   (tests/test_admission.py pins this).
  Ticket           one queued simulation request: the prepared per-lane
                   payload, a completion event the handler thread waits on,
                   and the batch_info the observability layer turns into a
                   `batch` span.
  BatchScheduler   the single dispatch thread. Collects a coalescing window
                   (first arrival, then up to `window_s` for concurrent
                   requests to join), splits it by batch-compatibility key,
                   and PIPELINES windows: window k's device results are
                   harvested (ops/hostfetch.AsyncFetch.get) only after
                   window k+1's upload+dispatch is in flight, so the
                   device→host fetch of one window hides under the next
                   window's encode/dispatch — the serving-side double
                   buffer, same mechanism as PR 6's bench loop.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

from kubernetes_autoscaler_tpu_torch.sidecar import faults
from kubernetes_autoscaler_tpu_torch.sidecar.lifecycle import Stamps


class WorldValidationError(ValueError):
    """A structurally invalid tenant world or request, rejected BEFORE it
    reaches a coalescing window (docs/ROBUSTNESS.md): mapped to gRPC
    INVALID_ARGUMENT, counted by `world_validation_rejects_total{reason}`.
    Reasons form a small fixed taxonomy pinned by tests/test_quarantine.py:
    `nan` (NaN/inf in request params or template capacities),
    `negative-request` (negative resource requests in the world or params),
    `section-version-mismatch` (a delta built against a different snapshot
    version than the server holds — the post-restart full-resend signal),
    `oversize-world` (counts past the configured world caps), and
    `rehydration-pending` (a checkpoint-restored tenant hit a path that
    needs the native world re-sent)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"invalid world/request [{reason}]"
                         + (f": {detail}" if detail else ""))
        self.reason = reason


class Quarantined(Exception):
    """The tenant is serving a quarantine sentence (a window failure was
    bisected down to it): rejected at the admission edge with gRPC
    FAILED_PRECONDITION + the parole time as a retry-after hint. Auto-
    parole: the next request after the TTL elapses is admitted (and a
    successful ApplyDelta paroles early — a new world is a new chance)."""

    def __init__(self, tenant: str, reason: str, retry_after_ms: int):
        super().__init__(
            f"tenant {tenant or 'default'!r} quarantined [{reason}]; "
            f"parole in {retry_after_ms}ms")
        self.tenant = tenant
        self.reason = reason
        self.retry_after_ms = retry_after_ms


class SchedulerDown(RuntimeError):
    """The batch scheduler thread is dead: nothing drains the admission
    queue, so accepting the request would wedge it until its deadline.
    Mapped to gRPC UNAVAILABLE — the client's retry ladder / circuit
    breaker / local fallback takes over (the Health RPC reports
    NOT_SERVING so orchestration restarts the sidecar)."""


class QueueFull(Exception):
    """Admission bound hit: reject now, retry after `retry_after_ms`.

    Mapped to gRPC RESOURCE_EXHAUSTED by the server handler. The request was
    NOT enqueued — retrying it later is always safe (nothing partial
    happened), which tests/test_admission.py proves end to end.

    `reason` distinguishes WHY the reject fired — `queue-full` (admission
    depth bound) vs `tenant-cap` (resident-world table bound) — so the
    server's `admission_rejects_total{reason}` and the event sink can tell
    an overloaded queue (transient; retry helps) from a full tenant table
    (structural; retry alone never helps, an operator must drop_tenant or
    run a bigger sidecar)."""

    def __init__(self, depth: int | None, retry_after_ms: int,
                 what: str = "admission queue",
                 reason: str = "queue-full"):
        where = (f"{depth} queued" if isinstance(depth, int)
                 else "server backpressure")
        super().__init__(
            f"{what} full ({where}); retry in {retry_after_ms}ms")
        self.depth = depth
        self.retry_after_ms = retry_after_ms
        self.reason = reason


@dataclass
class Ticket:
    tenant: str
    kind: str                    # "up" | "down"
    key: tuple                   # batch-compatibility key (shape class + statics)
    lane: object                 # prepared per-lane input (sidecar/batch.py)
    fp: tuple | None = None      # world fingerprint (stack-cache key part)
    trace_id: str | None = None
    result: object = None
    error: Exception | None = None
    batch_info: dict | None = None
    done: threading.Event = field(default_factory=threading.Event)
    enqueued_ns: int = field(default_factory=time.perf_counter_ns)
    # request-lifecycle marks (sidecar/lifecycle.py): the queue stamps
    # `enqueue`/`collected`; the dispatch path stamps the batch-level marks
    stamps: Stamps = field(default_factory=Stamps)

    def wait(self, timeout_s: float = 60.0):
        if not self.done.wait(timeout_s):
            raise TimeoutError(
                f"{self.kind} ticket for tenant {self.tenant!r} not served "
                f"within {timeout_s:.0f}s (scheduler wedged?)")
        if self.error is not None:
            raise self.error
        return self.result

    def resolve(self, result=None, error: Exception | None = None,
                batch_info: dict | None = None) -> None:
        self.result = result
        self.error = error
        self.batch_info = batch_info
        self.done.set()


class AdmissionQueue:
    """Bounded queue with per-tenant sub-queues and a persistent round-robin
    cursor (fairness holds ACROSS windows too: the tenant served last in one
    window is first only when its turn comes around again)."""

    def __init__(self, max_depth: int = 128, retry_after_ms: int = 20):
        self.max_depth = max_depth
        self.retry_after_ms = retry_after_ms
        self._cond = threading.Condition()
        self._by_tenant: dict[str, deque[Ticket]] = {}
        self._ring: list[str] = []       # tenant round-robin order
        self._cursor = 0
        self.depth = 0
        self.submitted = 0
        self.rejected = 0
        self._closed: Exception | None = None

    def close(self, error: Exception) -> None:
        """Fail-fast mode after a scheduler crash: every future submit
        raises SchedulerDown instead of enqueuing into a queue nobody
        drains (the supervision contract, tests/test_fault_injection.py)."""
        with self._cond:
            self._closed = error
            self._cond.notify_all()

    def submit(self, t: Ticket) -> None:
        with self._cond:
            if self._closed is not None:
                raise SchedulerDown(
                    f"admission queue closed: {self._closed}"
                ) from self._closed
            if self.depth >= self.max_depth:
                self.rejected += 1
                raise QueueFull(self.depth, self.retry_after_ms)
            dq = self._by_tenant.get(t.tenant)
            if dq is None:
                dq = deque()
                self._by_tenant[t.tenant] = dq
                self._ring.append(t.tenant)
            if not t.stamps.enqueue:
                t.stamps.enqueue = time.perf_counter_ns()
            dq.append(t)
            self.depth += 1
            self.submitted += 1
            self._cond.notify_all()

    def collect(self, max_lanes: int, wait_s: float,
                coalesce_s: float) -> list[Ticket]:
        """One coalescing window: block up to `wait_s` for a first ticket,
        then hold the window open `coalesce_s` (or until `max_lanes` tickets
        are waiting) so concurrent in-flight requests coalesce, then pop
        round-robin. Empty list = idle timeout."""
        with self._cond:
            deadline = time.monotonic() + wait_s
            while self.depth == 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._cond.wait(remaining)
            cdeadline = time.monotonic() + coalesce_s
            while self.depth < max_lanes:
                remaining = cdeadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            return self._pop_round_robin(max_lanes)

    def _pop_round_robin(self, max_lanes: int) -> list[Ticket]:
        out: list[Ticket] = []
        collected_ns = time.perf_counter_ns()
        while len(out) < max_lanes and self.depth > 0:
            # one full cycle over the ring = at most one ticket per tenant
            took_any = False
            n = len(self._ring)
            for _ in range(n):
                if len(out) >= max_lanes:
                    break
                tenant = self._ring[self._cursor % len(self._ring)]
                self._cursor = (self._cursor + 1) % len(self._ring)
                dq = self._by_tenant.get(tenant)
                if dq:
                    t = dq.popleft()
                    t.stamps.collected = collected_ns
                    out.append(t)
                    self.depth -= 1
                    took_any = True
            if not took_any:
                break
        # prune empty tenants so the ring stays proportional to ACTIVE
        # tenants (the cursor re-anchors; fairness is per-cycle, unaffected)
        if any(not dq for dq in self._by_tenant.values()):
            live = [t for t in self._ring if self._by_tenant.get(t)]
            for t in list(self._by_tenant):
                if not self._by_tenant[t]:
                    del self._by_tenant[t]
            self._cursor = 0 if not live else self._cursor % len(live)
            self._ring = live
        return out

    def drain(self) -> list[Ticket]:
        with self._cond:
            out = [t for dq in self._by_tenant.values() for t in dq]
            self._by_tenant.clear()
            self._ring.clear()
            self.depth = 0
            return out


def split_by_key(window: list[Ticket]) -> list[list[Ticket]]:
    """Group a window's tickets into batch-compatible runs (same vmapped
    program: kind + shape class + static params), preserving first-seen
    order so fairness inside the window survives the split."""
    groups: dict[tuple, list[Ticket]] = {}
    order: list[tuple] = []
    for t in window:
        if t.key not in groups:
            groups[t.key] = []
            order.append(t.key)
        groups[t.key].append(t)
    return [groups[k] for k in order]


class BatchScheduler:
    """The dispatch thread. `dispatch(batch)` (the service's stacked-vmap
    issue path) must return an in-flight handle with a `.harvest()` method
    that blocks for the device→host fetch and resolves every ticket; the
    scheduler calls it one window LATE to overlap fetch with the next
    window's dispatch."""

    def __init__(self, queue: AdmissionQueue, dispatch, lanes: int,
                 window_s: float = 0.002, idle_wait_s: float = 0.05,
                 window_max: int | None = None, gap_cb=None,
                 on_batch_failure=None, on_crash=None):
        self.queue = queue
        self.dispatch = dispatch
        self.lanes = max(int(lanes), 1)
        # the window collects MORE than one dispatch's lanes (a window mixes
        # batch keys; each key run then chunks into lane-width dispatches) —
        # decoupling the coalescing cap from the compiled lane width lets the
        # lane width stay small (padding is wasted compute on lane-serial
        # backends) without shrinking the coalescing opportunity
        self.window_max = max(int(window_max or 4 * self.lanes), self.lanes)
        self.window_s = window_s
        self.idle_wait_s = idle_wait_s
        self.windows = 0
        self.batches = 0
        # device-utilization accounting: `gap_cb(gap_seconds, cause)` fires
        # per dispatch with the estimated device idle since the previous
        # batch's results were ready. Causes:
        #   pipelined  an unharvested batch was still in flight when this
        #              dispatch launched — the device had queued work, so
        #              the gap is 0 BY CONSTRUCTION (the pipelining
        #              contract, CI-asserted ≈0 under load)
        #   stall      the previous harvest completed WITH work already
        #              waiting in the queue, yet the device sat idle until
        #              this dispatch — a genuine pipeline failure
        #   idle       the previous harvest completed with an empty queue;
        #              the gap is arrival-bound (no work to run), reported
        #              separately so idle fleets don't read as stalls
        self.gap_cb = gap_cb
        # isolation hooks (docs/ROBUSTNESS.md): on_batch_failure(batch,
        # error) — a failed dispatch is handed to the service's bisection
        # re-dispatcher instead of blanket-failing every member;
        # on_crash(error) — the supervision escalation when the serve loop
        # itself dies (the service flips Health to NOT_SERVING)
        self.on_batch_failure = on_batch_failure
        self.on_crash = on_crash
        self.crashed: Exception | None = None
        self._last_harvest_done_ns: int | None = None
        self._work_waiting_at_harvest = False
        self._pending = None   # previous batch, fetch still in flight
        self._window: list[Ticket] = []   # collected, not yet all dispatched
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._serve, name="katpu-batch-scheduler", daemon=True)

    def start(self) -> "BatchScheduler":
        self._thread.start()
        return self

    @property
    def alive(self) -> bool:
        return self.crashed is None and self._thread.is_alive()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        self._thread.join(timeout_s)
        err = RuntimeError("sidecar batch scheduler stopped")
        for t in self.queue.drain():
            t.resolve(error=err)

    def _serve(self) -> None:
        """Supervised serve loop: an unhandled exception (anything outside
        the per-batch dispatch guard — queue plumbing, window forming, an
        injected scheduler_loop fault) must NOT die silently with requests
        queued behind a drain that will never come. The crash path closes
        the queue (future submits raise SchedulerDown), fails every queued
        and in-flight ticket, and escalates through on_crash so the service
        flips Health to NOT_SERVING."""
        try:
            self._serve_inner()
        except Exception as e:  # noqa: BLE001 — the supervision contract
            self.crashed = e
            err = SchedulerDown(f"batch scheduler crashed: {e!r}")
            err.__cause__ = e
            self.queue.close(err)
            for t in self.queue.drain():
                t.resolve(error=err)
            # tickets already COLLECTED into the current window live in
            # neither the queue nor _pending — without this they would
            # block their clients until the gRPC deadline, the exact hang
            # the supervision contract exists to prevent
            for t in self._window:
                if not t.done.is_set():
                    t.resolve(error=err)
            self._window = []
            if self._pending is not None:
                for t in getattr(self._pending, "tickets", ()):
                    if not t.done.is_set():
                        t.resolve(error=err)
                self._pending = None
            if self.on_crash is not None:
                try:
                    self.on_crash(e)
                except Exception:  # noqa: BLE001 — escalation is best-effort
                    pass

    def _serve_inner(self) -> None:
        while not self._stop.is_set():
            if faults.PLAN is not None:
                faults.PLAN.fire("scheduler_loop")
            # with a fetch in flight, poll instead of sleeping: an empty
            # queue means there is nothing to overlap the fetch with, and
            # the waiters of the pending batch may be exactly what the next
            # request is blocked on (request-response clients) — sleeping
            # idle_wait_s here adds a dead stall to every round trip
            window = self.queue.collect(
                self.window_max,
                wait_s=0.0 if self._pending is not None else self.idle_wait_s,
                coalesce_s=self.window_s)
            if not window:
                # idle: nothing to overlap the pending fetch with — harvest
                if self._pending is not None:
                    self._harvest(self._pending)
                    self._pending = None
                continue
            self._window = window
            self.windows += 1
            for run in split_by_key(window):
                # canonical member order: the round-robin cursor rotates the
                # pop order window to window, but lane order is irrelevant to
                # latency (a batch completes together) and a STABLE order
                # keys the server's stacked-pytree cache — steady-state
                # windows with the same members must re-hit, not restack
                run.sort(key=lambda t: (t.tenant, t.enqueued_ns))
                for lo in range(0, len(run), self.lanes):
                    batch = run[lo:lo + self.lanes]
                    self.batches += 1
                    self._note_gap(self._pending is not None)
                    try:
                        inflight = self.dispatch(batch)
                    except Exception as e:  # noqa: BLE001 — fail the batch, keep serving
                        # a failed dispatch is handed to the service's
                        # bisection re-dispatcher when one is wired: split
                        # lanes, retry halves, isolate the poison member —
                        # healthy co-batched tenants still get results
                        if self.on_batch_failure is not None:
                            try:
                                self.on_batch_failure(batch, e)
                            except Exception as e2:  # noqa: BLE001
                                for t in batch:
                                    if not t.done.is_set():
                                        t.resolve(error=e2)
                        else:
                            for t in batch:
                                t.resolve(error=e)
                        continue
                    # pipeline point: THIS batch's upload+dispatch is now in
                    # flight; only now pay the previous batch's fetch wait
                    if self._pending is not None:
                        self._harvest(self._pending)
                    self._pending = inflight
            self._window = []
        if self._pending is not None:
            self._harvest(self._pending)
            self._pending = None

    def _note_gap(self, pipelined: bool) -> None:
        """Estimated device idle before the dispatch about to launch (see
        gap_cb causes above). Host-side estimator: the device's results-ready
        time is observed as the previous harvest's completion."""
        if self.gap_cb is None:
            return
        if pipelined:
            self.gap_cb(0.0, "pipelined")
            return
        if self._last_harvest_done_ns is None:
            return   # first dispatch ever: no previous batch to idle after
        gap_s = (time.perf_counter_ns() - self._last_harvest_done_ns) / 1e9
        self.gap_cb(gap_s,
                    "stall" if self._work_waiting_at_harvest else "idle")

    def _harvest(self, inflight) -> None:
        try:
            inflight.harvest()
        except Exception:  # noqa: BLE001 — harvest resolves tickets itself
            pass
        finally:
            self._last_harvest_done_ns = time.perf_counter_ns()
            self._work_waiting_at_harvest = self.queue.depth > 0

"""Span tracer + flight recorder: per-loop timelines, not just totals.

`metrics/phases.py` answers "how much did each cost domain cost this
process-lifetime"; this module answers "what did THIS RunOnce look like" —
the question a breached loop SLO (tests/test_loop_slo.py) actually raises.
Three pieces:

  Tracer         loop-scoped trace id + monotonically ordered begin/end spans
                 with nesting, free-form attributes and counter events.
                 Recording a span is two `perf_counter_ns` calls and a list
                 append; with no active tracer the instrumentation sites
                 (PhaseStats.phase, the sidecar client) reduce to one
                 thread-local read, so tracing-off costs nothing measurable.
  activate()     installs a tracer as the thread's active tracer so deep
                 layers (phase spans, cache counters, RPC clients) find it
                 without plumbing a handle through every call.
  FlightRecorder bounded ring of the last N loop traces, held by
                 StaticAutoscaler. Always on: when a loop breaches its
                 wall-clock budget, raises, or served an armed `/snapshotz`,
                 the evidence is *already recorded* and gets persisted to
                 disk as one Chrome-trace/Perfetto JSON file — debugging
                 after the fact instead of asking the operator to reproduce.

Cross-process traces: the sidecar client stamps the trace id into gRPC
request metadata (sidecar/wire.TRACE_ID_HEADER); the server runs the RPC
under its own Tracer with the SAME id and returns its spans in the response
(`"trace"` field), which `add_remote_spans` merges. Span timestamps are
wall-clock anchored (`time.time_ns` at tracer construction + perf-counter
offsets) so spans from both processes land on one aligned timeline.

Export is the Chrome trace-event format (`{"traceEvents": [...]}` with
"X"-phase complete events, ts/dur in microseconds) — loadable directly in
Perfetto (https://ui.perfetto.dev) and `chrome://tracing`.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from collections import deque

# spans per trace cap: a pathological loop (e.g. a hot retry loop inside a
# phase) must not grow a trace without bound; drops are counted and visible
MAX_SPANS_PER_TRACE = 100_000

_tls = threading.local()


def current_tracer() -> "Tracer | None":
    """The thread's active tracer, or None (the zero-cost path)."""
    return getattr(_tls, "tracer", None)


def activate(tracer: "Tracer | None") -> "Tracer | None":
    """Install `tracer` as this thread's active tracer; returns the previous
    one so callers can restore it (see `active()` for the with-form)."""
    prev = getattr(_tls, "tracer", None)
    _tls.tracer = tracer
    return prev


class active:
    """`with active(tracer): ...` — scoped activate/restore."""

    def __init__(self, tracer: "Tracer | None"):
        self.tracer = tracer

    def __enter__(self):
        self._prev = activate(self.tracer)
        return self.tracer

    def __exit__(self, *exc):
        activate(self._prev)
        return False


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


class Tracer:
    """One trace (normally: one RunOnce). Spans are stored as mutable lists
    `[name, cat, begin_ns, dur_ns, depth, args|None]` — begin_ns relative to
    the tracer's perf-counter epoch, dur_ns None while the span is open."""

    __slots__ = ("trace_id", "process", "_t0_ns", "wall0_us", "spans",
                 "_stack", "counters", "remote", "dropped")

    def __init__(self, trace_id: str | None = None, process: str = "autoscaler"):
        self.trace_id = trace_id or new_trace_id()
        self.process = process
        self._t0_ns = time.perf_counter_ns()
        self.wall0_us = time.time_ns() // 1000
        self.spans: list[list] = []
        self._stack: list[int] = []
        self.counters: dict[str, int] = {}
        self.remote: list[dict] = []    # merged child-process span groups
        self.dropped = 0

    # ---- span recording ----

    def begin(self, name: str, cat: str = "", **args) -> int:
        """Open a nested span; returns its index for `end()`. Attribute
        values must be JSON-serializable (they ride into the export)."""
        if len(self.spans) >= MAX_SPANS_PER_TRACE:
            self.dropped += 1
            return -2    # sentinel: the matching end() becomes a no-op
        idx = len(self.spans)
        self.spans.append([name, cat, time.perf_counter_ns() - self._t0_ns,
                           None, len(self._stack), args or None])
        self._stack.append(idx)
        return idx

    def end(self, idx: int = -1, **args) -> None:
        """Close the innermost open span (or everything down to and
        including `idx`, which makes phase/except interactions safe: a child
        left open by an exception is closed with its parent)."""
        if idx == -2:    # the begin() was dropped at the span cap
            return
        now = time.perf_counter_ns() - self._t0_ns
        if idx == -1:
            if not self._stack:
                return
            idx = self._stack[-1]
        while self._stack:
            top = self._stack.pop()
            span = self.spans[top]
            if span[3] is None:
                span[3] = now - span[2]
            if top == idx:
                break
        if args and 0 <= idx < len(self.spans):
            span = self.spans[idx]
            span[5] = {**(span[5] or {}), **args}

    class _SpanCtx:
        __slots__ = ("tracer", "idx")

        def __init__(self, tracer, idx):
            self.tracer = tracer
            self.idx = idx

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.tracer.end(self.idx)
            return False

    def span(self, name: str, cat: str = "", **args) -> "Tracer._SpanCtx":
        """`with tracer.span("confirm", cat="planner"): ...`"""
        return Tracer._SpanCtx(self, self.begin(name, cat, **args))

    def add_span(self, name: str, cat: str = "",
                 begin_abs_ns: int | None = None, dur_ns: int = 0,
                 **args) -> None:
        """Append an already-timed CLOSED span recorded by another thread —
        e.g. the sidecar's batch scheduler measured a coalesced dispatch
        window and each member RPC's handler tracer adopts it. Timestamps
        are absolute `perf_counter_ns` values (comparable across threads of
        one process); they are rebased onto this tracer's epoch. The span
        does not touch the open-span stack, so it can be added mid-RPC."""
        if len(self.spans) >= MAX_SPANS_PER_TRACE:
            self.dropped += 1
            return
        t0 = (time.perf_counter_ns() if begin_abs_ns is None else begin_abs_ns)
        self.spans.append([name, cat, t0 - self._t0_ns, max(int(dur_ns), 0),
                           len(self._stack), args or None])

    def annotate(self, **args) -> None:
        """Merge attributes into the innermost open span (root span if none
        is open)."""
        if not self.spans:
            return
        idx = self._stack[-1] if self._stack else 0
        span = self.spans[idx]
        span[5] = {**(span[5] or {}), **args}

    def bump(self, event: str, n: int = 1) -> None:
        """Trace-level counter (cache hits/misses, transfer counts, …);
        exported as args on the root span."""
        self.counters[event] = self.counters.get(event, 0) + n

    # ---- cross-process merge ----

    def add_remote_spans(self, group: dict) -> None:
        """Merge a child process's reported spans. `group` is the shape the
        sidecar server returns: {"trace_id", "process", "spans": [{"name",
        "cat", "ts_us", "dur_us", "depth", "args"}]} — ts_us wall-anchored
        in the REMOTE process, valid on this timeline because both processes
        share a wall clock (same machine / NTP domain)."""
        if not isinstance(group, dict) or not group.get("spans"):
            return
        self.remote.append({"process": str(group.get("process", "remote")),
                            "spans": list(group["spans"])})

    # ---- export ----

    def snapshot(self) -> dict:
        """JSON-able view of the trace (closed spans only — an owner
        snapshotting mid-span sees everything already completed)."""
        return {
            "trace_id": self.trace_id,
            "process": self.process,
            "wall0_us": self.wall0_us,
            "spans": [
                {"name": s[0], "cat": s[1],
                 "ts_us": self.wall0_us + s[2] // 1000,
                 "dur_us": s[3] // 1000, "depth": s[4],
                 **({"args": s[5]} if s[5] else {})}
                for s in self.spans if s[3] is not None
            ],
            "counters": dict(self.counters),
            "remote": list(self.remote),
            "dropped": self.dropped,
        }


def chrome_trace_events(snapshots: list[dict]) -> list[dict]:
    """Flatten trace snapshots into Chrome trace events. All local spans ride
    pid 1 / tid 1 (nesting is containment of [ts, ts+dur) intervals, which
    sequential loops preserve); each distinct remote process gets its own
    pid so Perfetto shows the cross-process hop as two aligned tracks."""
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 1,
         "args": {"name": "autoscaler"}},
    ]
    remote_pids: dict[str, int] = {}
    for snap in snapshots:
        tid_args = {"trace_id": snap["trace_id"]}
        for i, s in enumerate(snap.get("spans", ())):
            args = {**tid_args, **s.get("args", {})}
            if i == 0 and snap.get("counters"):
                args["counters"] = snap["counters"]
            events.append({
                "name": s["name"], "cat": s.get("cat") or "span", "ph": "X",
                "ts": s["ts_us"], "dur": max(s["dur_us"], 1),
                "pid": 1, "tid": 1, "args": args,
            })
        for group in snap.get("remote", ()):
            proc = group["process"]
            if proc not in remote_pids:
                remote_pids[proc] = 2 + len(remote_pids)
                events.append({"name": "process_name", "ph": "M",
                               "pid": remote_pids[proc], "tid": 1,
                               "args": {"name": proc}})
            for s in group["spans"]:
                events.append({
                    "name": s["name"], "cat": s.get("cat") or "span",
                    "ph": "X", "ts": s["ts_us"], "dur": max(s["dur_us"], 1),
                    "pid": remote_pids[proc], "tid": 1,
                    "args": {**tid_args, **s.get("args", {})},
                })
    return events


class TailSampler:
    """Tail-based per-request trace retention (the serving-side analog of
    the FlightRecorder's whole-ring dump).

    The FlightRecorder answers "what did the loops before the breach look
    like" by dumping everything; at serving rates (thousands of requests per
    second) retaining every request trace is a memory bomb and dumping the
    ring on each slow request is an I/O bomb. A tail sampler decides AFTER
    the request completes — when its latency and outcome are known — whether
    the full trace is worth keeping:

      * always-keep reasons: `failed`, `backpressure`, `slo_breach` — the
        requests a post-mortem starts from;
      * `slow`: e2e above the rolling slow-quantile estimate (a bounded
        reservoir of recent latencies; quantile re-estimated lazily), so the
        retained set tracks the CURRENT tail, not a static threshold;
      * everything else is dropped (only its latency feeds the reservoir).

    The retained set is a bounded ring with eviction accounting
    (`offered` / `retained` / `evicted` + per-reason counts), exportable as
    one Perfetto file (`to_chrome_trace`) or filtered per tenant
    (`tenant_traces`) for tenant-scoped SLO-breach dumps. `retain()` returns
    the trace id, which the caller attaches as the latency histogram
    bucket's EXEMPLAR — the link from a bad p99 in /metrics to a retained
    trace."""

    # quantile re-estimation stride: the threshold is recomputed from the
    # reservoir every K inserts, not per request — a sort per RPC would
    # serialize all handler threads on the sampler lock doing O(n log n)
    # of redundant work at serving rates
    REESTIMATE_EVERY = 16

    def __init__(self, capacity: int = 64, slow_quantile: float = 0.95,
                 reservoir: int = 512, min_observations: int = 32):
        self.capacity = max(int(capacity), 1)
        self.slow_quantile = float(slow_quantile)
        self.min_observations = int(min_observations)
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._lat: deque[float] = deque(maxlen=int(reservoir))
        self._thresh: float | None = None       # cached slow threshold
        self._since_estimate = 0
        self._lock = threading.Lock()
        self.offered = 0
        self.retained = 0
        self.evicted = 0
        self.reasons: dict[str, int] = {}

    # ---- latency feed + slow classification ----

    def observe_latency(self, e2e_s: float) -> bool:
        """Feed the reservoir; True when `e2e_s` sits in the slow tail.
        Before `min_observations` latencies arrive nothing classifies as
        slow (a cold server would otherwise retain its first N requests
        and squat the budget on warmup compiles). The quantile threshold
        is re-estimated lazily, every REESTIMATE_EVERY inserts."""
        with self._lock:
            self._lat.append(float(e2e_s))
            if len(self._lat) < self.min_observations:
                return False
            self._since_estimate += 1
            if (self._thresh is None
                    or self._since_estimate >= self.REESTIMATE_EVERY):
                xs = sorted(self._lat)
                idx = min(int(len(xs) * self.slow_quantile), len(xs) - 1)
                self._thresh = xs[idx]
                self._since_estimate = 0
            return e2e_s >= self._thresh

    def offer(self, snapshot: dict, e2e_s: float,
              reason: str | None = None) -> str | None:
        """Offer one completed request's trace snapshot. `reason` is an
        always-keep override (`failed` / `backpressure` / `slo_breach`);
        with None the rolling quantile decides (`slow`). Returns the trace
        id when retained (→ exemplar), else None."""
        slow = self.observe_latency(e2e_s)
        with self._lock:
            self.offered += 1
            if reason is None and not slow:
                return None
            reason = reason or "slow"
            snap = dict(snapshot)
            snap["retain_reason"] = reason
            snap["e2e_s"] = float(e2e_s)
            if len(self._ring) == self._ring.maxlen:
                self.evicted += 1
            self._ring.append(snap)
            self.retained += 1
            self.reasons[reason] = self.reasons.get(reason, 0) + 1
            return snap.get("trace_id")

    # ---- export ----

    def traces(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def tenant_traces(self, tenant: str) -> list[dict]:
        """Only the retained traces whose request belonged to `tenant` —
        the tenant-scoped SLO-breach dump's content (never the whole
        ring)."""
        return [s for s in self.traces() if s.get("tenant") == tenant]

    def stats(self) -> dict:
        with self._lock:
            return {"offered": self.offered, "retained": self.retained,
                    "evicted": self.evicted, "held": len(self._ring),
                    "reasons": dict(self.reasons)}

    def to_chrome_trace(self, snaps: list[dict] | None = None) -> dict:
        snaps = self.traces() if snaps is None else snaps
        return {
            "traceEvents": chrome_trace_events(snaps),
            "otherData": {
                "sampler": self.stats(),
                "trace_ids": [s["trace_id"] for s in snaps],
                "retain_reasons": {s["trace_id"]: s.get("retain_reason", "")
                                   for s in snaps},
            },
        }

    def dump(self, path: str, snaps: list[dict] | None = None) -> str:
        doc = self.to_chrome_trace(snaps)
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


class FlightRecorder:
    """Bounded ring of the last `capacity` loop traces (capacity 0 disables
    tracing entirely — StaticAutoscaler then never constructs a Tracer and
    the instrumentation sites take their no-tracer path).

    `record()` is the single entry: it snapshots the tracer into the ring
    and, when `dump_reason` is set and a `dump_dir` is configured, persists
    the WHOLE ring (the loops leading up to the event are exactly what a
    post-mortem needs) as one Perfetto file."""

    def __init__(self, capacity: int = 8, dump_dir: str = ""):
        self.capacity = max(int(capacity), 0)
        self.dump_dir = dump_dir
        self._ring: deque[dict] = deque(maxlen=self.capacity or 1)
        self._lock = threading.Lock()
        self.recorded = 0
        self.dumps = 0

    def record(self, tracer: Tracer, dump_reason: str = "") -> str | None:
        """Snapshot `tracer` into the ring; returns the dump path when a
        dump fired, else None."""
        if self.capacity == 0:
            return None
        snap = tracer.snapshot()
        if dump_reason:
            snap["dump_reason"] = dump_reason
        with self._lock:
            self._ring.append(snap)
            self.recorded += 1
        if dump_reason and self.dump_dir:
            try:
                os.makedirs(self.dump_dir, exist_ok=True)
                path = os.path.join(
                    self.dump_dir, f"flight-{tracer.trace_id}.trace.json")
                return self.dump(path)
            except OSError:
                return None    # a full/readonly disk must never sink the loop
        return None

    def traces(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def to_chrome_trace(self) -> dict:
        snaps = self.traces()
        return {
            "traceEvents": chrome_trace_events(snaps),
            "otherData": {
                "recorded_total": self.recorded,
                "trace_ids": [s["trace_id"] for s in snaps],
                "dump_reasons": {s["trace_id"]: s["dump_reason"]
                                 for s in snaps if "dump_reason" in s},
            },
        }

    def dump(self, path: str) -> str:
        """Write the ring as one Chrome-trace JSON file; returns `path`."""
        doc = self.to_chrome_trace()
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)   # readers never observe a half-written dump
        with self._lock:
            self.dumps += 1
        return path

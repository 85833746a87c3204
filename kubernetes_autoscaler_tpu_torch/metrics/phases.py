"""Per-phase wall-clock accounting for the autoscaler's host paths.

Both hot loops cross the same five cost domains each RunOnce —
  encode    host objects → tensors (models/encode, models/incremental,
            the orchestrator's template-tensor cache)
  dispatch  device program launches (drain sweep, predicate planes,
            estimate_all + scoring on the scale-up side)
  fetch     device → host transfers (ops/hostfetch batched fetches,
            option-score readback)
  marshal   host-side numpy marshalling for the native confirm tier
  confirm   the confirmation pass itself (native C++ or Python fallback;
            scale-up: the lossy-winner oracle verification)
— and a single opaque per-loop number cannot say which one regressed.
`PhaseStats` is a zero-dependency accumulator its owner (scale-down Planner,
ScaleUpOrchestrator) holds; it ALSO mirrors observations into a
metrics.Registry histogram (`planner_phase_seconds{phase=...}`) when one is
attached, so the breakdown rides the normal exposition path. bench.py prints
`snapshot()` next to the headline p50 so the metric ships with its per-phase
decomposition.

Every phase additionally opens a span in the thread's ACTIVE trace
(metrics/trace.current_tracer — set per RunOnce by StaticAutoscaler's flight
recorder, or by bench.py --trace), tagged with the owner as its category, so
planner and orchestrator phases appear on the loop timeline for free. With no
active tracer the extra cost is a single thread-local read.

Phases may nest (a mirror miss inside `marshal` opens a `fetch` span);
totals then overlap — they are per-domain costs, not a partition of wall
clock. `events` is a free-form counter side-channel for cache hit/miss
accounting (the marshal cache, the elig-plane cache, oracle-call counts);
each bump mirrors into the trace's counters and, when a registry is
attached, the `phase_events_total{owner=,event=}` counter — so cache and
transfer accounting are first-class registry metrics, not bench-JSON-only.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from kubernetes_autoscaler_tpu_torch.metrics import trace

PHASES = ("encode", "dispatch", "fetch", "marshal", "confirm")

# steady-state encode/fetch spans sit well under 1 ms (the whole host share
# of a loop is tens of ms at 5k nodes) — the registry's default buckets
# start at 5 ms and would flatten the entire distribution into one bucket
PHASE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0)
_PHASE_HELP = ("Per-phase host-path wall clock of the scale-down planner and "
               "scale-up orchestrator (encode/dispatch/fetch/marshal/confirm "
               "spans, seconds; sub-ms buckets)")
_EVENTS_HELP = ("Free-form phase event counters (cache hits/misses, batched "
                "device transfers, re-estimate dispatches) keyed by owner")


@dataclass
class PhaseStats:
    totals_s: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)
    events: dict[str, int] = field(default_factory=dict)
    registry: object | None = None      # optional metrics.Registry
    owner: str = ""                     # span category: planner | scaleup | …

    @contextmanager
    def phase(self, name: str, **attrs):
        tracer = trace.current_tracer()
        span = (tracer.begin(name, cat=self.owner or "phase", **attrs)
                if tracer is not None else None)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals_s[name] = self.totals_s.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            if tracer is not None:
                tracer.end(span)
            if self.registry is not None:
                self.registry.histogram(
                    "planner_phase_seconds", help=_PHASE_HELP,
                    buckets=PHASE_BUCKETS).observe(dt, phase=name)

    def observe(self, name: str, seconds: float) -> None:
        """Record an externally-timed interval into a phase's totals and the
        registry histogram WITHOUT opening a span — for intervals whose span
        already exists elsewhere on the trace (the async batched fetch opens
        its own `fetch` span at issue time; the blocking remainder measured
        at harvest must still count toward planner_phase_seconds{fetch}, and
        a nested span here would end the still-open async span out of LIFO
        order)."""
        self.totals_s[name] = self.totals_s.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1
        if self.registry is not None:
            self.registry.histogram(
                "planner_phase_seconds", help=_PHASE_HELP,
                buckets=PHASE_BUCKETS).observe(seconds, phase=name)

    def bump(self, event: str, n: int = 1) -> None:
        self.events[event] = self.events.get(event, 0) + n
        tracer = trace.current_tracer()
        if tracer is not None:
            tracer.bump(event, n)
        if self.registry is not None:
            self.registry.counter("phase_events_total", help=_EVENTS_HELP).inc(
                n, owner=self.owner or "phase", event=event)

    def snapshot(self) -> dict:
        """One JSON-friendly view: per-phase totals (ms) + spans + events."""
        return {
            "totals_ms": {k: round(v * 1000.0, 3)
                          for k, v in sorted(self.totals_s.items())},
            "spans": dict(sorted(self.counts.items())),
            "events": dict(sorted(self.events.items())),
        }

    def reset(self) -> None:
        self.totals_s.clear()
        self.counts.clear()
        self.events.clear()

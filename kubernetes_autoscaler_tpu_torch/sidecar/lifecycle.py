"""Request-lifecycle decomposition + per-tenant SLO budgets for the sidecar.

`rpc_duration_seconds{tenant}` says a request took N ms; this module says
WHERE those ms went. Every admitted request is stamped with monotonic
`perf_counter_ns` marks at each hand-off of the serving pipeline and the
decomposition is derived as CONTIGUOUS intervals, so the phases sum to the
end-to-end latency by construction (CI asserts the sum within tolerance —
a drifting sum means a stamp went missing, not that clocks skewed):

  encode    RPC entry → ticket enqueued: world export at class shape,
            node-group template lowering, lane build (under ts.lock)
  queue     enqueued → popped into a window: admission-queue wait PLUS the
            coalescing window the scheduler held open for joiners
  form      window popped → stack start: split-by-key, canonical member
            sort, chunking, and any wait behind earlier chunks' dispatches
  stack     member numpy worlds → one stacked device pytree (0 on a stack
            cache hit — steady windows re-hit instead of re-uploading)
  dispatch  the vmapped sim call: program launch (async backends return
            before compute finishes) + issuing the async result fetch
  harvest   fetch issued → results on host. Includes the deliberate
            pipeline delay (window k is harvested only after window k+1's
            dispatch is in flight) — from the REQUEST's view all of it is
            waiting for results
  assembly  host pytree → this member's JSON response
  reply     ticket resolved → the handler thread actually woke and took
            the response (scheduler→handler hand-off latency)

The serial (non-batched / constrained) path stamps the subset that exists
there: encode, dispatch, harvest (response build including device→host
reads); queue/form/stack/reply are structurally zero and omitted.

The decomposition rides three surfaces at once (docs/OBSERVABILITY.md):
per-tenant histograms `request_phase_seconds{phase,tenant}` (stale-zeroed
on drop_tenant), a closed `lifecycle` span tree on the request's trace, and
a `lifecycle` block in the gRPC response JSON so the CLIENT's RunOnce trace
can show server-side queue time distinct from network time (client-observed
RPC wall minus server e2e ≈ wire + serialization).

`SloBudgets` is the per-tenant latency budget table: a tenant class (or the
client itself, via `wire.SLO_BUDGET_MS_HEADER`) declares how slow is too
slow; a breach bumps `tenant_slo_breaches_total{tenant}` and triggers a
TENANT-SCOPED tail-sampler dump (only that tenant's retained request
traces, never the whole ring — see server._on_complete).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

# canonical phase order (batched path); the serial path uses the subset
# (encode, dispatch, harvest)
LIFECYCLE_PHASES = ("encode", "queue", "form", "stack", "dispatch",
                    "harvest", "assembly", "reply")

# request phases span ~10 µs (assembly) to ~100 ms (a cold-compile
# dispatch); the registry's default 5ms-start buckets would flatten them
REQUEST_PHASE_BUCKETS = (0.00001, 0.000025, 0.00005, 0.0001, 0.00025,
                         0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                         0.1, 0.25, 0.5, 1.0, 2.5, 10.0)


@dataclass
class Stamps:
    """Monotonic `perf_counter_ns` marks along one request's pipeline.
    Batch-level marks (stack/dispatch/harvest/assembly) are shared by every
    member of the batch — the hand-offs happen once per batch."""

    entry: int = 0          # RPC body entry (before world export)
    enqueue: int = 0        # ticket submitted to the admission queue
    collected: int = 0      # popped into a coalescing window
    stack0: int = 0         # batch stacking began
    stack1: int = 0         # stacked device pytree ready
    dispatched: int = 0     # vmapped sim launched + async fetch issued
    harvested: int = 0      # results on host
    resolved: int = 0       # this member's response assembled + resolved
    woke: int = 0           # handler thread woke with the response

    def phases_ns(self) -> dict[str, int]:
        """Contiguous decomposition; only phases whose both endpoints were
        stamped appear (the serial path stamps a subset). Negative clamps
        guard perf-counter reads racing across threads (sub-µs skew)."""
        marks = [("encode", self.entry, self.enqueue),
                 ("queue", self.enqueue, self.collected),
                 ("form", self.collected, self.stack0),
                 ("stack", self.stack0, self.stack1),
                 ("dispatch", self.stack1, self.dispatched),
                 ("harvest", self.dispatched, self.harvested),
                 ("assembly", self.harvested, self.resolved),
                 ("reply", self.resolved, self.woke)]
        out: dict[str, int] = {}
        prev_end = 0
        for name, a, b in marks:
            if a and b:
                out[name] = max(b - a, 0)
            elif b and prev_end:
                # a stamp is missing upstream (serial path): charge from the
                # last stamped mark so the chain stays contiguous
                out[name] = max(b - prev_end, 0)
            prev_end = b or prev_end
        return out

    def e2e_ns(self) -> int:
        last = self.woke or self.resolved or self.harvested
        return max(last - self.entry, 0) if self.entry and last else 0


def lifecycle_block(stamps: Stamps, batch_id: str | None = None,
                    trace_id: str | None = None) -> dict:
    """The `lifecycle` block a gRPC response carries: phase milliseconds +
    e2e, so the client sees server-side time decomposed and can derive
    network time as (client rpc wall − e2e_ms)."""
    phases = {k: round(v / 1e6, 4) for k, v in stamps.phases_ns().items()}
    block = {"phases_ms": phases,
             "e2e_ms": round(stamps.e2e_ns() / 1e6, 4)}
    if batch_id:
        block["batch_id"] = batch_id
    if trace_id:
        block["trace_id"] = trace_id
    return block


def add_lifecycle_spans(tracer, stamps: Stamps, cat: str = "lifecycle",
                        **root_args) -> None:
    """Emit the decomposition as a CLOSED `lifecycle` span tree on
    `tracer`: one parent spanning e2e, one child per phase, all from the
    absolute perf-counter stamps (Tracer.add_span rebases them), so the
    Perfetto dump shows queue vs dispatch vs harvest as nested intervals
    without any live begin/end bracketing."""
    if tracer is None or not stamps.entry:
        return
    tracer.add_span("lifecycle", cat=cat, begin_abs_ns=stamps.entry,
                    dur_ns=stamps.e2e_ns(), **root_args)
    t = stamps.entry
    for name, dur in stamps.phases_ns().items():
        tracer.add_span(f"lifecycle/{name}", cat=cat, begin_abs_ns=t,
                        dur_ns=dur)
        t += dur


class SloBudgets:
    """Per-tenant latency budgets (milliseconds). A tenant without an
    explicit budget uses the default; a default of 0 disables breach
    detection for unconfigured tenants. Budgets may be set server-side
    (config) or declared by the client per request via
    `wire.SLO_BUDGET_MS_HEADER` (last write wins — the client knows its
    own loop deadline best)."""

    def __init__(self, default_ms: float = 0.0,
                 budgets: dict[str, float] | None = None):
        self.default_ms = float(default_ms)
        self._budgets: dict[str, float] = dict(budgets or {})
        self._lock = threading.Lock()

    def set(self, tenant: str, budget_ms: float) -> None:
        with self._lock:
            self._budgets[tenant] = float(budget_ms)

    def get(self, tenant: str) -> float:
        with self._lock:
            return self._budgets.get(tenant, self.default_ms)

    def drop(self, tenant: str) -> None:
        with self._lock:
            self._budgets.pop(tenant, None)

    def breached(self, tenant: str, e2e_s: float) -> bool:
        budget = self.get(tenant)
        return budget > 0 and e2e_s * 1000.0 > budget

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._budgets)

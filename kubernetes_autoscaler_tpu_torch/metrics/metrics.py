"""Metrics registry: counters/gauges/histograms + prometheus text exposition.

Reference counterpart: metrics/metrics.go — ~45 series under
`cluster_autoscaler_*`, notably the per-phase `function_duration_seconds`
histogram (metrics.go:324) updated around every RunOnce stage, plus the
liveness HealthCheck keyed on loop activity (liveness.go).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60)


@dataclass
class Counter:
    name: str
    help: str = ""
    _values: dict[tuple, float] = field(default_factory=dict)
    # updates are read-modify-write and metrics are written from multiple
    # threads (the sidecar's gRPC pool, the parallel scale-up executor) —
    # an unlocked inc under contention silently loses increments
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)

    def total(self) -> float:
        """Sum over EVERY label combination — e.g. the whole-process h2d
        byte total across tenant-labelled series (value() reads exactly one
        series and misses the labelled ones)."""
        with self._lock:
            return sum(self._values.values())

    def zero_matching(self, **labels) -> None:
        """Stale-label zeroing (the reason-plane convention from the status
        layer): every series whose label set CONTAINS `labels` resets to 0 —
        e.g. a dropped tenant's rpc_total{tenant=...} series must not keep
        claiming traffic for a tenant that no longer exists. A counter reset
        to 0 is well-formed prometheus (clients handle counter resets)."""
        items = set(labels.items())
        with self._lock:
            for key in self._values:
                if items <= set(key):
                    self._values[key] = 0.0

    def items(self) -> list[tuple[tuple, float]]:
        """Snapshot of every (label-key-tuple, value) series — the public
        accessor for aggregations over a whole family (audit_stats and
        kin), instead of reaching into the private storage."""
        with self._lock:
            return list(self._values.items())


@dataclass
class Gauge:
    name: str
    help: str = ""
    _values: dict[tuple, float] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._values[tuple(sorted(labels.items()))] = v

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)

    def zero_matching(self, **labels) -> None:
        """Stale-label zeroing, gauge edition (the drop_tenant sweep
        contract from the counter/histogram families extended to the
        device-residency gauges): every series whose label set contains
        `labels` resets to 0 — a dropped tenant's `tenant_hbm_bytes` /
        `resident_bytes` must not keep claiming device memory."""
        items = set(labels.items())
        with self._lock:
            for key in self._values:
                if items <= set(key):
                    self._values[key] = 0.0


@dataclass
class Histogram:
    name: str
    help: str = ""
    buckets: tuple = _DEFAULT_BUCKETS
    _counts: dict[tuple, list] = field(default_factory=dict)
    _sums: dict[tuple, float] = field(default_factory=dict)
    # (series key, bucket index) -> (trace_id, observed value): the last
    # exemplar landing in that bucket. Only observations explicitly carrying
    # an exemplar (a tail-sampled trace id) are stored, so every exemplar in
    # the exposition resolves to a RETAINED trace — a bad p99 bucket links
    # straight to its Perfetto evidence instead of a sampled-away id.
    _exemplars: dict[tuple, tuple] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def observe(self, v: float, exemplar: str | None = None, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            for i, b in enumerate(self.buckets):
                if v <= b:
                    counts[i] += 1
                    bucket = i
                    break
            else:
                counts[-1] += 1
                bucket = len(self.buckets)
            self._sums[key] = self._sums.get(key, 0.0) + v
            if exemplar:
                self._exemplars[(key, bucket)] = (exemplar, v)

    def count(self, **labels) -> int:
        with self._lock:
            return sum(self._counts.get(tuple(sorted(labels.items())), []))

    def exemplars(self, **labels) -> dict[int, tuple]:
        """bucket index -> (trace_id, value) for one series."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            return {b: ex for (k, b), ex in self._exemplars.items()
                    if k == key}

    def zero_matching(self, **labels) -> None:
        """Stale-label zeroing: bucket counts, sums and exemplars of every
        series whose label set contains `labels` reset (see Counter)."""
        items = set(labels.items())
        with self._lock:
            for key in self._counts:
                if items <= set(key):
                    self._counts[key] = [0] * (len(self.buckets) + 1)
                    self._sums[key] = 0.0
            for kb in [kb for kb in self._exemplars if items <= set(kb[0])]:
                del self._exemplars[kb]


class Registry:
    def __init__(self, prefix: str = "cluster_autoscaler"):
        self.prefix = prefix
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help), help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help), help)

    def histogram(self, name: str, help: str = "", buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, lambda: Histogram(name, help, buckets), help)

    def _get(self, name: str, make, help: str = ""):
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = make()
            m = self._metrics[name]
            # a later accessor may carry the family's help string while the
            # first (hot-path) touch did not — upgrade so the exposition's
            # `# HELP` line does not depend on call order
            if help and not getattr(m, "help", ""):
                m.help = help
            return m

    @contextmanager
    def time_function(self, label: str):
        """reference: function_duration_seconds histogram per FunctionLabel
        (+ the quantile variant, metrics.go function_duration_quantile)."""
        h = self.histogram("function_duration_seconds")
        q = self.histogram("function_duration_quantile_seconds")
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            h.observe(dt, function=label)
            q.observe(dt, function=label)

    def expose_text(self) -> str:
        """Prometheus exposition format (consumed by the /metrics endpoint)."""
        lines = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            full = f"{self.prefix}_{name}"
            if getattr(m, "help", ""):
                lines.append(f"# HELP {full} {m.help}")
            # snapshot under the metric's own lock: a scrape racing a
            # writer thread must neither see torn values nor die on
            # "dict changed size during iteration"
            if isinstance(m, Counter):
                lines.append(f"# TYPE {full} counter")
                with m._lock:
                    values = list(m._values.items())
                for key, v in values:
                    lines.append(f"{full}{_fmt(key)} {v}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {full} gauge")
                with m._lock:
                    values = list(m._values.items())
                for key, v in values:
                    lines.append(f"{full}{_fmt(key)} {v}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {full} histogram")
                with m._lock:
                    rows = [(key, list(counts), m._sums.get(key, 0.0),
                             {b: ex for (k, b), ex in m._exemplars.items()
                              if k == key})
                            for key, counts in m._counts.items()]
                for key, counts, total, exemplars in rows:
                    cum = 0
                    for i, b in enumerate(m.buckets):
                        cum += counts[i]
                        lines.append(f'{full}_bucket{_fmt(key, le=str(b))} '
                                     f'{cum}{_fmt_exemplar(exemplars.get(i))}')
                    cum += counts[-1]
                    lines.append(
                        f'{full}_bucket{_fmt(key, le="+Inf")} {cum}'
                        f"{_fmt_exemplar(exemplars.get(len(m.buckets)))}")
                    lines.append(f"{full}_sum{_fmt(key)} {total}")
                    lines.append(f"{full}_count{_fmt(key)} {cum}")
        return "\n".join(lines) + "\n"


def _fmt(key: tuple, **extra) -> str:
    items = list(key) + sorted(extra.items())
    if not items:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + inner + "}"


def _fmt_exemplar(ex: tuple | None) -> str:
    """OpenMetrics exemplar suffix for a bucket line:
    `... 17 # {trace_id="abc"} 0.042` — the trace id resolves to a
    tail-sampler-retained Perfetto trace (metrics/trace.TailSampler)."""
    if not ex:
        return ""
    trace_id, v = ex
    return f' # {{trace_id="{trace_id}"}} {v}'


# ---- extra exposition registries (in-process sidecar parity) ----
#
# The control plane's /metrics mux serves `default_registry`; a sidecar
# running IN the same process (bench, tests, single-binary deployments)
# registers its own Registry here so the mux exposes the identical series
# the sidecar `Metricz` RPC serves — one scrape surface, two transports,
# same families (the Metricz RPC conversely appends default_registry).
# Held by WEAK reference: a service that is dropped without close() (or
# that leaks in tests) falls out of the exposition with its registry
# instead of being scraped as a ghost forever.
_extra_expositions: list = []      # list[weakref.ref[Registry]]
_extra_lock = threading.Lock()


def register_exposition(registry: Registry) -> None:
    import weakref

    with _extra_lock:
        _extra_expositions[:] = [r for r in _extra_expositions
                                 if r() is not None]
        if not any(r() is registry for r in _extra_expositions):
            _extra_expositions.append(weakref.ref(registry))


def unregister_exposition(registry: Registry) -> None:
    with _extra_lock:
        _extra_expositions[:] = [r for r in _extra_expositions
                                 if r() is not None and r() is not registry]


def expose_all_text() -> str:
    """default_registry + every live registered extra registry, one
    exposition — what the /metrics mux serves."""
    with _extra_lock:
        extras = [r() for r in _extra_expositions if r() is not None]
    return "".join([default_registry.expose_text()]
                   + [r.expose_text() for r in extras])


@dataclass
class HealthCheck:
    """reference: metrics/liveness.go — fails liveness when the loop stalls
    (--max-inactivity), keeps failing (--max-failing-time), or never completes
    a first successful run (--max-startup-time)."""

    max_inactivity_s: float = 600.0
    max_failing_time_s: float = 900.0
    max_startup_time_s: float = 1200.0
    started: float = field(default_factory=time.time)
    last_activity: float = field(default_factory=time.time)
    last_success: float = 0.0
    last_failure: float = 0.0

    def mark_active(self, now: float | None = None) -> None:
        now = time.time() if now is None else now
        self.last_activity = now
        self.last_success = now

    def mark_failed(self, now: float | None = None) -> None:
        now = time.time() if now is None else now
        self.last_activity = now
        self.last_failure = now

    def healthy(self, now: float | None = None) -> bool:
        now = time.time() if now is None else now
        if self.last_success == 0.0:
            # never completed a run: bounded by the startup budget
            return now - self.started <= self.max_startup_time_s
        if now - self.last_activity > self.max_inactivity_s:
            return False
        if (self.last_failure > self.last_success
                and now - self.last_success > self.max_failing_time_s):
            return False
        return True


default_registry = Registry()

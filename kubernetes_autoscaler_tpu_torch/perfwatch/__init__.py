"""Perf observatory: the longitudinal layer over bench.py's evidence.

bench.py made every round emit a measured JSON line (docs/BENCH.md, the
never-null contract) — but until this package the lines were write-only:
printed, maybe eyeballed, discarded. perfwatch banks them:

  * `history`  — PerfHistory, an append-only chain-sealed JSONL store
    (one row per bench mode per run) with rotation, drop accounting and
    STRICT lineage separation: a cpu-floor row can never become a tpu
    baseline, closing the PR 7 "cpu recorded as tpu evidence" bug class
    structurally rather than by reviewer vigilance.
  * `detect`   — a noise-robust regression detector: per (metric,
    lineage, shape) rolling median + MAD bands, min-samples warmup, and
    a direction-policy table (latency/bytes/recompiles up = bad;
    speedup/hit-rate down = bad).
  * `triage`   — every confirmed regression emits a self-contained
    evidence bundle (the shadow-audit pattern): metric delta + baseline
    window, compile-census variant diff, per-phase span diffs, counter
    diffs, trace id / journal cursor when present.
  * `report`   — terminal trajectory table + markdown report + the
    bench --all per-mode summary table.
  * `cli`      — `python -m kubernetes_autoscaler_tpu_torch.perfwatch
    {log,check,report,gate,seed}`; `gate` exits nonzero on confirmed
    regressions (advisory mode reports only).

Registry families (`bench_runs_total{mode,backend}`,
`perf_regressions_total{metric,severity}`,
`perf_history_dropped_total{reason}`) ride the normal exposition path and
are served identically by /metrics and Metricz (PARITY.md).
"""

from kubernetes_autoscaler_tpu_torch.perfwatch.history import (  # noqa: F401
    HISTORY_VERSION,
    SCHEMA_VERSION,
    HistoryTamperError,
    PerfHistory,
    flatten_metrics,
    lineage_of,
    shape_signature,
)

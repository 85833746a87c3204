"""Noise-robust regression detection over PerfHistory rows.

Baselines are per (metric, lineage, shape_sig) — the lineage axis is
structural (history.py): a cpu-floor row is never compared against tpu
rows, and vice versa, no matter how the store was assembled.

Statistics: rolling median + MAD over the last `window` baseline values.
MAD (scaled by 1.4826 to estimate sigma under normality) is robust to the
occasional outlier run that would wreck a mean/stddev band; bench
latencies on shared CI runners jitter by tens of percent, so the band is
additionally floored at `rel_floor × |median|` — a constant series
(MAD = 0) does not produce a zero-width band that flags the next run's
scheduler noise. Below `min_samples` baselines a key yields `no-baseline`
(warmup), never a regression.

Direction policy: a table keyed on the metric/key NAME decides which way
is bad (latency/bytes/recompiles up = bad; speedup/hit-rate down = bad)
and which class the key gates under:

  * gate    — statistical band on the headline `value`s; a confirmed
    breach fails `perfwatch gate`.
  * exact   — invariant counters (steady_state_recompiles,
    loop_device_round_trips, driver_deaths, ...): ANY bad-direction move
    past the baseline extremum is a regression — these are contracts the
    repo CI already asserts pointwise; the history makes drift across
    runs visible too.
  * observe — everything else numeric (phase spans, census figures,
    intermediate ratios): verdicts are computed and reported for triage
    context but never fail the gate — one flaky sub-span must not turn
    the gate into a coin flip.
"""

from __future__ import annotations

import dataclasses
import re
import statistics

GATE = "gate"
EXACT = "exact"
OBSERVE = "observe"

UP_BAD = "up-bad"
DOWN_BAD = "down-bad"

_REGRESSIONS_HELP = "Confirmed perf regressions, by metric and severity"

# MAD → sigma under a normal noise model
_MAD_SIGMA = 1.4826


@dataclasses.dataclass(frozen=True)
class Policy:
    direction: str          # UP_BAD | DOWN_BAD
    klass: str              # GATE | EXACT | OBSERVE
    rel_floor: float = 0.30  # minimum band half-width as fraction of |median|


# Two ordered rule tables, first match wins.
#
# _METRIC_RULES judge the headline key `value` by the METRIC name (the
# semantics live there — a *_p50_ms value is latency, a
# *_clusters_per_sec value is throughput). A mode's headline gates BY
# DEFAULT: a headline metric with no explicit rule still gets a
# direction-inferred GATE policy (rel_floor 0.40) — new bench modes are
# born gated, and opting a headline out of the gate takes an explicit
# OBSERVE rule here, visible in review.
_METRIC_RULES: list[tuple[re.Pattern, Policy]] = [
    (re.compile(p), pol) for p, pol in [
        (r"^scaleup_sim_p50_ms_", Policy(UP_BAD, GATE, rel_floor=0.35)),
        (r"^runonce_e2e_p50_ms", Policy(UP_BAD, GATE, rel_floor=0.35)),
        (r"^fused_loop_e2e", Policy(UP_BAD, GATE, rel_floor=0.35)),
        (r"^multi_tenant_clusters_per_sec$",
         Policy(DOWN_BAD, GATE, rel_floor=0.35)),
        (r"^whatif_multiverse$", Policy(UP_BAD, GATE, rel_floor=0.40)),
        (r"^world_store_churn$", Policy(UP_BAD, GATE, rel_floor=0.40)),
        (r"^local_chaos_control_loop$",
         Policy(UP_BAD, GATE, rel_floor=0.45)),
        (r"^journal_record_replay_smoke$",
         Policy(UP_BAD, GATE, rel_floor=0.45)),
        (r"^shadow_audit_smoke$", Policy(UP_BAD, GATE, rel_floor=0.50)),
        (r"^device_stats$", Policy(UP_BAD, GATE, rel_floor=0.40)),
        # a virtual-mesh dryrun's value is an ok-flag, not a measurement
        (r"^multichip_dryrun$", Policy(DOWN_BAD, OBSERVE)),
    ]]

# _KEY_RULES judge every other flattened key by the KEY name.
_KEY_RULES: list[tuple[re.Pattern, Policy]] = [
    (re.compile(p), pol) for p, pol in [
        # ---- exact invariant counters: the repo's pointwise CI contracts
        (r"(^|\.)steady_state_recompiles$", Policy(UP_BAD, EXACT)),
        (r"(^|\.)recompiles_per_new_tenant$", Policy(UP_BAD, EXACT)),
        (r"(^|\.)loop_device_round_trips", Policy(UP_BAD, EXACT)),
        (r"(^|\.)driver_deaths$", Policy(UP_BAD, EXACT)),
        (r"(^|\.)(zero_drift|null_lane_identical|verdicts_identical"
         r"|identical_to_cold_encode|decisions_identical)$",
         Policy(DOWN_BAD, EXACT)),
        # ---- observed families: direction matters for the report ----
        # bigger-is-better ratios first: h2d_reduction_vs_full is a
        # REDUCTION factor, not a byte count — it must not fall into the
        # bytes rule below
        (r"(per_sec|speedup|hit_rate|reduction|occupancy|retained"
         r"|vs_baseline)", Policy(DOWN_BAD, OBSERVE)),
        (r"(^|\.)(h2d|d2h|bytes|_mb$|_mib$)", Policy(UP_BAD, OBSERVE)),
        (r"(_ms|_ns|_s)$", Policy(UP_BAD, OBSERVE)),
        (r"(^|\.)(p50|p95|p99|mean|max)$", Policy(UP_BAD, OBSERVE)),
        (r"overhead", Policy(UP_BAD, OBSERVE)),
        (r"(dispatches|recompiles|drops|deferrals|resends|evictions)",
         Policy(UP_BAD, OBSERVE)),
    ]]

_FALLBACK = Policy(UP_BAD, OBSERVE)


def _first_match(rules, subject: str) -> Policy | None:
    for pat, pol in rules:
        if pat.search(subject):
            return pol
    return None


def policy_for(metric: str, key: str) -> Policy:
    """Never returns None. Headline `value`s gate (direction from the
    metric name, throughput-style names flip to down-bad); every other
    unknown key falls back to observe/up-bad — a number we cannot
    interpret is reported, never gated."""
    if key == "value":
        pol = _first_match(_METRIC_RULES, metric)
        if pol is not None:
            return pol
        inferred = _first_match(_KEY_RULES, metric) or _FALLBACK
        return Policy(inferred.direction, GATE, rel_floor=0.40)
    return _first_match(_KEY_RULES, key) or _FALLBACK


@dataclasses.dataclass
class Verdict:
    metric: str
    key: str
    lineage: str
    shape_sig: str
    status: str              # stable | improved | regressed | no-baseline
    severity: str            # none | minor | major | critical
    value: float | None
    baseline_median: float | None
    baseline_mad: float | None
    baseline_n: int
    window: list[float]
    delta: float | None
    delta_frac: float | None
    threshold: float | None
    direction: str
    klass: str
    run: str = ""
    baseline_runs: list[str] = dataclasses.field(default_factory=list)

    @property
    def gates(self) -> bool:
        return self.klass in (GATE, EXACT)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class RegressionDetector:
    """`check_row` judges one history row against its exact-lineage
    baselines; `check_run` fans that over every row of one run id.
    `registry` (optional) gets `perf_regressions_total{metric,severity}`
    bumped once per confirmed gating regression."""

    def __init__(self, min_samples: int = 3, window: int = 12,
                 k_mad: float = 4.0, registry=None,
                 include_observe: bool = False):
        self.min_samples = max(1, int(min_samples))
        self.window = max(2, int(window))
        self.k_mad = float(k_mad)
        self.registry = registry
        self.include_observe = include_observe

    # ---- plumbing ----

    def baselines_for(self, all_rows: list[dict], row: dict) -> list[dict]:
        """The rolling window: same metric, SAME lineage, same shape
        signature; never dropped rows, never rows of the judged run, only
        rows sealed earlier."""
        seq = row.get("seq", 1 << 62)
        run = row.get("run", "")
        base = [r for r in all_rows
                if r.get("metric") == row.get("metric")
                and r.get("lineage") == row.get("lineage")
                and r.get("shape_sig") == row.get("shape_sig")
                and not r.get("dropped")
                and r.get("seq", -1) < seq
                and (not run or r.get("run") != run)]
        return base[-self.window:]

    def check_run(self, all_rows: list[dict], run_id: str,
                  lineage: str | None = None) -> list[Verdict]:
        out: list[Verdict] = []
        for row in all_rows:
            if row.get("run") != run_id or row.get("dropped"):
                continue
            if lineage is not None and row.get("lineage") != lineage:
                continue
            out.extend(self.check_row(all_rows, row))
        return out

    def check_row(self, all_rows: list[dict], row: dict) -> list[Verdict]:
        base = self.baselines_for(all_rows, row)
        out: list[Verdict] = []
        metric = str(row.get("metric") or "")
        for key, value in (row.get("metrics") or {}).items():
            pol = policy_for(metric, key)
            if pol.klass == OBSERVE and not self.include_observe:
                continue
            pairs = [(str(r.get("run") or ""), float(r["metrics"][key]))
                     for r in base
                     if isinstance(r.get("metrics", {}).get(key),
                                   (int, float))]
            v = self._judge(metric, key, row, pol, pairs, float(value))
            if v is not None:
                out.append(v)
        return out

    # ---- the statistics ----

    def _judge(self, metric: str, key: str, row: dict, pol: Policy,
               pairs: list[tuple[str, float]], value: float
               ) -> Verdict | None:
        series = [v for _, v in pairs]
        common = dict(metric=metric, key=key,
                      lineage=str(row.get("lineage") or ""),
                      shape_sig=str(row.get("shape_sig") or ""),
                      run=str(row.get("run") or ""),
                      direction=pol.direction, klass=pol.klass,
                      window=list(series), baseline_n=len(series),
                      baseline_runs=[r for r, _ in pairs])
        if len(series) < self.min_samples:
            return Verdict(status="no-baseline", severity="none",
                           value=value, baseline_median=None,
                           baseline_mad=None, delta=None, delta_frac=None,
                           threshold=None, **common)
        med = float(statistics.median(series))
        mad = float(statistics.median([abs(s - med) for s in series]))
        if pol.klass == EXACT:
            return self._judge_exact(pol, series, value, med, mad, common)
        thr = max(self.k_mad * _MAD_SIGMA * mad,
                  pol.rel_floor * abs(med), 1e-9)
        delta = value - med
        bad = delta if pol.direction == UP_BAD else -delta
        if bad > thr:
            status = "regressed"
            ratio = bad / thr
            severity = ("minor" if ratio <= 2.0
                        else "major" if ratio <= 5.0 else "critical")
            self._count(metric, severity)
        elif bad < -thr:
            status, severity = "improved", "none"
        else:
            status, severity = "stable", "none"
        return Verdict(status=status, severity=severity, value=value,
                       baseline_median=med, baseline_mad=mad, delta=delta,
                       delta_frac=(delta / med if med else None),
                       threshold=thr, **common)

    def _judge_exact(self, pol: Policy, series: list[float], value: float,
                     med: float, mad: float, common: dict) -> Verdict:
        """Invariant counters: ANY bad-direction move past the baseline
        extremum regresses, at critical severity — one steady-state
        recompile is a broken contract, not noise."""
        if pol.direction == UP_BAD:
            bound = max(series)
            regressed, improved = value > bound, value < min(series)
        else:
            bound = min(series)
            regressed, improved = value < bound, value > max(series)
        status = ("regressed" if regressed
                  else "improved" if improved else "stable")
        severity = "critical" if regressed else "none"
        if regressed:
            self._count(common["metric"], severity)
        delta = value - bound
        return Verdict(status=status, severity=severity, value=value,
                       baseline_median=med, baseline_mad=mad, delta=delta,
                       delta_frac=(delta / bound if bound else None),
                       threshold=0.0, **common)

    def _count(self, metric: str, severity: str) -> None:
        if self.registry is not None:
            self.registry.counter(
                "perf_regressions_total", help=_REGRESSIONS_HELP,
            ).inc(metric=metric, severity=severity)


def gating_regressions(verdicts: list[Verdict]) -> list[Verdict]:
    return [v for v in verdicts if v.status == "regressed" and v.gates]

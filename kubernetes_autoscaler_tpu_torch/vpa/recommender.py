"""VPA recommender: usage histories → resource recommendations.

Reference counterpart: vertical-pod-autoscaler/pkg/recommender/ —
ClusterStateFeeder ingests pods/VPAs/metrics (input/cluster_feeder.go), each
(controller, container) gets an AggregateContainerState with decaying
histograms, and percentile estimators produce target/lower/upper
recommendations (logic/recommender.go:32-38: target=P90, lower=P50, upper=P95,
×(1+15% margin), floored by min-resources), written to VPA.Status.

TPU re-design: all aggregates' histograms live in two [A, B] tensors
(vpa/histogram.py); decay, sample ingestion and ALL percentile estimations are
three device calls per RunOnce regardless of aggregate count — the reference
iterates Go objects per container.

OOM handling mirrors cluster_feeder's OOM observation: an OOM bumps the memory
sample to max(usage, current-request) × safety margin.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from kubernetes_autoscaler_tpu_torch.vpa.histogram import (
    CPU_HALF_LIFE_S,
    CPU_SCHEME,
    MEMORY_HALF_LIFE_S,
    MEMORY_SCHEME,
    HistogramBank,
)
from kubernetes_autoscaler_tpu_torch.vpa.model import (
    ContainerUsageSample,
    RecommendedContainerResources,
    VerticalPodAutoscaler,
)

# reference: logic/recommender.go percentile/margin constants
TARGET_CPU_PERCENTILE = 0.9
LOWER_BOUND_PERCENTILE = 0.5
UPPER_BOUND_PERCENTILE = 0.95
TARGET_MEMORY_PEAK_PERCENTILE = 0.9
SAFETY_MARGIN = 1.15
MIN_CPU_CORES = 0.025           # reference: pod_min_cpu_millicores=25
MIN_MEMORY_BYTES = 250e6        # reference: pod_min_memory_mb=250
OOM_BUMP_RATIO = 1.2            # reference: model.OOMBumpUpRatio


@dataclass
class AggregateKey:
    namespace: str
    owner_name: str
    container_name: str

    def id(self) -> tuple:
        return (self.namespace, self.owner_name, self.container_name)


@dataclass
class Recommender:
    initial_aggregates: int = 64
    _index: dict[tuple, int] = field(default_factory=dict)
    device: object = None        # the banks' device: None = CUDA, "cpu" in tests

    def __post_init__(self):
        self.cpu = HistogramBank(self.initial_aggregates, CPU_SCHEME, CPU_HALF_LIFE_S,
                                 device=self.device)
        self.memory = HistogramBank(self.initial_aggregates, MEMORY_SCHEME,
                                    MEMORY_HALF_LIFE_S, device=self.device)
        self.first_sample_time: dict[tuple, float] = {}
        self.sample_counts: dict[tuple, int] = {}

    # ---- feeding (reference: ClusterStateFeeder.LoadRealTimeMetrics) ----

    def _row(self, key: AggregateKey) -> int:
        kid = key.id()
        if kid not in self._index:
            self._index[kid] = len(self._index)
            if len(self._index) > self.cpu.weights.shape[0]:
                self.cpu.grow(2 * len(self._index))
                self.memory.grow(2 * len(self._index))
        return self._index[kid]

    def feed(self, samples: list[ContainerUsageSample],
             now: float | None = None) -> None:
        now = time.time() if now is None else now
        self.cpu.decay_to(now)
        self.memory.decay_to(now)
        cpu_rows, cpu_vals = [], []
        mem_rows, mem_vals = [], []
        for s in samples:
            key = AggregateKey(s.namespace, s.owner_name, s.container_name)
            row = self._row(key)
            kid = key.id()
            self.first_sample_time.setdefault(kid, s.timestamp or now)
            if s.cpu_cores is not None:
                # confidence counts CPU samples only (reference getConfidence
                # — otherwise cpu+memory datapoints double the sample rate)
                self.sample_counts[kid] = self.sample_counts.get(kid, 0) + 1
                cpu_rows.append(row)
                cpu_vals.append(s.cpu_cores)
            if s.memory_bytes is not None:
                mem_rows.append(row)
                val = s.memory_bytes
                if s.is_oom:
                    val *= OOM_BUMP_RATIO
                mem_vals.append(val)
        # CPU sample weight = max(usage, 0.1) per reference CPU weighting
        # (aggregate_container_state.go: weight by usage); memory weight 1.
        if cpu_rows:
            w = np.maximum(np.asarray(cpu_vals, np.float32), 0.1)
            self.cpu.add_samples(np.asarray(cpu_rows), np.asarray(cpu_vals), w)
        if mem_rows:
            self.memory.add_samples(np.asarray(mem_rows), np.asarray(mem_vals))

    def feed_history(self, samples: list[ContainerUsageSample],
                     now: float) -> None:
        """Batched historical ingestion: mathematically identical to feeding
        each sample at its own timestamp (decay is exponential, so a sample
        aged `now - t` simply carries weight x 2^(-(age)/half_life)), but the
        whole history lands in ONE scatter-add per resource instead of a
        device dispatch pair per sample."""
        self.cpu.decay_to(now)
        self.memory.decay_to(now)
        cpu_rows, cpu_vals, cpu_w = [], [], []
        mem_rows, mem_vals, mem_w = [], [], []
        for s in samples:
            key = AggregateKey(s.namespace, s.owner_name, s.container_name)
            row = self._row(key)
            kid = key.id()
            t = s.timestamp or now
            prev = self.first_sample_time.get(kid)
            if prev is None or t < prev:
                self.first_sample_time[kid] = t
            if s.cpu_cores is not None:
                # CPU samples only, matching feed() (see note there)
                self.sample_counts[kid] = self.sample_counts.get(kid, 0) + 1
            age = max(now - t, 0.0)
            if s.cpu_cores is not None:
                cpu_rows.append(row)
                cpu_vals.append(s.cpu_cores)
                cpu_w.append(max(s.cpu_cores, 0.1)
                             * 2.0 ** (-age / self.cpu.half_life_s))
            if s.memory_bytes is not None:
                mem_rows.append(row)
                val = s.memory_bytes
                if s.is_oom:
                    val *= OOM_BUMP_RATIO
                mem_vals.append(val)
                mem_w.append(2.0 ** (-age / self.memory.half_life_s))
        if cpu_rows:
            self.cpu.add_samples(np.asarray(cpu_rows), np.asarray(cpu_vals),
                                 np.asarray(cpu_w, np.float32))
        if mem_rows:
            self.memory.add_samples(np.asarray(mem_rows), np.asarray(mem_vals),
                                    np.asarray(mem_w, np.float32))

    # ---- estimation (reference: logic/recommender.go RecommendedPodResources) ----

    def _confidence_days(self, kid: tuple, now: float) -> float:
        """History confidence in days (reference: logic/estimator.go
        getConfidence — min of lifespan-days and samples-per-minute-days)."""
        first = self.first_sample_time.get(kid, now)
        life_days = max(now - first, 0.0) / 86400.0
        sample_days = self.sample_counts.get(kid, 0) / (60.0 * 24.0)
        return min(life_days, sample_days)

    @staticmethod
    def _confidence_scale(value: float, conf: float, multiplier: float,
                          exponent: float) -> float:
        """reference: confidenceMultiplier — value x (1 + m/conf)^e; with no
        history the bounds blow wide open (upper) / collapse (lower)."""
        if conf <= 0:
            return value * (1e9 if exponent > 0 else 0.0)
        return value * (1.0 + multiplier / conf) ** exponent

    def recommend(self, vpas: list[VerticalPodAutoscaler],
                  containers_by_target: dict[str, list[str]],
                  now: float | None = None) -> None:
        """Fill VPA.recommendation for every VPA; all percentiles computed in
        six device reductions total (3 quantiles × 2 resources)."""
        now = time.time() if now is None else now
        cpu_p50 = self.cpu.percentile(LOWER_BOUND_PERCENTILE)
        cpu_p90 = self.cpu.percentile(TARGET_CPU_PERCENTILE)
        cpu_p95 = self.cpu.percentile(UPPER_BOUND_PERCENTILE)
        mem_p50 = self.memory.percentile(LOWER_BOUND_PERCENTILE)
        mem_p90 = self.memory.percentile(TARGET_MEMORY_PEAK_PERCENTILE)
        mem_p95 = self.memory.percentile(UPPER_BOUND_PERCENTILE)

        for vpa in vpas:
            recs = []
            for container in containers_by_target.get(vpa.target_name, []):
                kid = (vpa.namespace, vpa.target_name, container)
                row = self._index.get(kid)
                if row is None:
                    continue
                policy = vpa.policy_for(container)
                if policy.mode == "Off":
                    continue

                def capped(cpu, mem):
                    cpu = max(cpu * SAFETY_MARGIN, MIN_CPU_CORES)
                    mem = max(mem * SAFETY_MARGIN, MIN_MEMORY_BYTES)
                    lo_c = policy.min_allowed.get("cpu")
                    hi_c = policy.max_allowed.get("cpu")
                    lo_m = policy.min_allowed.get("memory")
                    hi_m = policy.max_allowed.get("memory")
                    if lo_c is not None:
                        cpu = max(cpu, lo_c)
                    if hi_c is not None:
                        cpu = min(cpu, hi_c)
                    if lo_m is not None:
                        mem = max(mem, lo_m)
                    if hi_m is not None:
                        mem = min(mem, hi_m)
                    return {"cpu": cpu, "memory": mem}

                uncapped = {
                    "cpu": float(cpu_p90[row]) * SAFETY_MARGIN,
                    "memory": float(mem_p90[row]) * SAFETY_MARGIN,
                }
                # Confidence scaling (reference: WithConfidenceMultiplier —
                # lower bound x (1+0.001/conf)^-2, upper bound x (1+1/conf)^1):
                # young aggregates get a wide [lower, upper] band so the
                # updater doesn't churn pods on thin evidence.
                conf = self._confidence_days(kid, now)
                lo_cpu = self._confidence_scale(float(cpu_p50[row]), conf, 0.001, -2.0)
                lo_mem = self._confidence_scale(float(mem_p50[row]), conf, 0.001, -2.0)
                hi_cpu = self._confidence_scale(float(cpu_p95[row]), conf, 1.0, 1.0)
                hi_mem = self._confidence_scale(float(mem_p95[row]), conf, 1.0, 1.0)
                recs.append(RecommendedContainerResources(
                    container_name=container,
                    target=capped(float(cpu_p90[row]), float(mem_p90[row])),
                    lower_bound=capped(lo_cpu, lo_mem),
                    upper_bound=capped(hi_cpu, hi_mem),
                    uncapped_target=uncapped,
                ))
            vpa.recommendation = recs

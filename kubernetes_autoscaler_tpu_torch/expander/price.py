"""Price-based expander: cost-optimal node-group choice.

Reference counterpart: expander/price/price.go (priceBased.BestOptions) with
preferred.go (SimplePreferredNodeProvider + SimpleNodeUnfitness). The scoring
formula is reproduced exactly:

    priceSubScore = (total_node_price + stab) / (total_pod_price + stab)
    unfitness     = max(preferred_cpu/node_cpu, node_cpu/preferred_cpu)
    suppressed    = (unfitness - 1) * (1 - tanh((node_count - 1)/15)) + 1
    suppressed    = 1000 for GPU groups (gpuUnfitnessOverride)
    score         = suppressed * priceSubScore   (×2 if group doesn't exist)

lowest score wins; ties keep multiple options for the chain tail. Pod prices
use the helped-request totals the device scoring kernel already reduced
(ops/scoring.OptionScores.helped_req) — exact for linear pricing models, the
only kind the reference ships (gce/pricing.go).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from kubernetes_autoscaler_tpu_torch.cloudprovider.pricing import PricingModel
from kubernetes_autoscaler_tpu_torch.models.api import Node, Pod

_HOUR_S = 3600.0
_MIB = 1024.0 ** 2
_GIB = 1024.0 ** 3

# reference constants (price.go:52-76)
_STABILIZATION_POD = Pod(name="stabilize", requests={
    "cpu": 0.5, "memory": 500 * _MIB})
_NOT_EXIST_COEFFICIENT = 2.0
_GPU_UNFITNESS_OVERRIDE = 1000.0


def preferred_node_cpu_milli(cluster_size: int) -> int:
    """SimplePreferredNodeProvider (preferred.go:44-66): double the preferred
    node size every ~3x cluster growth."""
    if cluster_size <= 2:
        return 1000
    if cluster_size <= 6:
        return 2000
    if cluster_size <= 20:
        return 4000
    if cluster_size <= 60:
        return 8000
    if cluster_size <= 200:
        return 16000
    return 32000


def node_unfitness(preferred_cpu_milli: float, node_cpu_milli: float) -> float:
    """SimpleNodeUnfitness (preferred.go:86-92): cpu-ratio distance."""
    if node_cpu_milli <= 0 or preferred_cpu_milli <= 0:
        return _GPU_UNFITNESS_OVERRIDE
    return max(preferred_cpu_milli / node_cpu_milli,
               node_cpu_milli / preferred_cpu_milli)


@dataclass
class PriceBasedFilter:
    """Drop-in chain Filter (expander/strategies.py protocol). Needs loop
    context — cluster size changes every loop — which the orchestrator
    provides via set_loop_context before filtering."""

    pricing: PricingModel
    gpu_resource: str = "nvidia.com/gpu"
    cluster_size: int = 0
    horizon_s: float = _HOUR_S

    def set_loop_context(self, cluster_size: int) -> None:
        self.cluster_size = cluster_size

    def _pod_price_total(self, o) -> float:
        """Price of the helped-request totals as one synthetic pod (linear
        models make this exactly Σ pod_price)."""
        synthetic = Pod(name="helped-total", requests={
            "cpu": o.helped_cpu_milli / 1000.0,
            "memory": o.helped_mem_mib * _MIB,
            self.gpu_resource: o.helped_gpus,
        })
        return self.pricing.pod_price(synthetic, 0.0, self.horizon_s)

    def best_options(self, options):
        if not options:
            return []
        stab = self.pricing.pod_price(_STABILIZATION_POD, 0.0, self.horizon_s)
        preferred_cpu = float(preferred_node_cpu_milli(self.cluster_size))
        best: list = []
        best_score = 0.0
        for o in options:
            tmpl: Node | None = o.template
            if tmpl is None:
                continue
            node_price = self.pricing.node_price(tmpl, 0.0, self.horizon_s)
            total_node_price = node_price * o.node_count
            total_pod_price = self._pod_price_total(o)
            sub_score = (total_node_price + stab) / (total_pod_price + stab)
            cap = tmpl.alloc_or_cap()
            unfit = node_unfitness(preferred_cpu, float(cap.get("cpu", 0.0)) * 1000.0)
            suppressed = (unfit - 1.0) * (
                1.0 - math.tanh((o.node_count - 1) / 15.0)) + 1.0
            if float(cap.get(self.gpu_resource, 0.0)) > 0:
                suppressed = _GPU_UNFITNESS_OVERRIDE
            score = suppressed * sub_score
            if not o.exists:
                score *= _NOT_EXIST_COEFFICIENT
            if not best or score == best_score:
                best.append(o)
                best_score = score
            elif score < best_score:
                best = [o]
                best_score = score
        return best or list(options)

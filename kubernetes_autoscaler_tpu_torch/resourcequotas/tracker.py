"""Resource quotas: cluster-wide cores/memory/custom caps on scaling.

Reference counterpart: resourcequotas/ (tracker.go CheckDelta capping
scale-ups at orchestrator applyLimits :205-217; min-quota tracker gating
scale-down at planner.go:160; default provider wrapping the cloudprovider
ResourceLimiter).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from kubernetes_autoscaler_tpu_torch.cloudprovider.provider import ResourceLimiter
from kubernetes_autoscaler_tpu_torch.models import resources as res
from kubernetes_autoscaler_tpu_torch.models.api import Node
from kubernetes_autoscaler_tpu_torch.models.encode import node_capacity_vector

CORES = "cpu"
MEMORY = "memory"


def merge_flag_limits(limiter: ResourceLimiter, options) -> ResourceLimiter:
    """Fold --cores-total/--memory-total/--gpu-total caps into the provider's
    ResourceLimiter (reference: resourcequotas default provider wraps the flag
    limits; flags.go --cores-total et al.)."""
    max_limits = dict(limiter.max_limits)

    def cap(name: str, value: float) -> None:
        if value > 0:
            max_limits[name] = min(max_limits.get(name, 1 << 60), value)

    cap(CORES, options.max_cores_total)
    cap(MEMORY, options.max_memory_total_mib)
    cap("nvidia.com/gpu", options.max_gpu_total)
    return ResourceLimiter(min_limits=dict(limiter.min_limits),
                           max_limits=max_limits)


@dataclass
class QuotaStatus:
    """Current cluster totals in limiter units (cores, MiB, custom counts)."""

    totals: dict[str, float]


class QuotaTracker:
    """Tracks totals and answers 'how many nodes of this template may I add /
    remove' (reference: resourcequotas.Tracker)."""

    def __init__(self, limiter: ResourceLimiter, registry: res.ExtendedResourceRegistry):
        self.limiter = limiter
        self.registry = registry

    def status(self, nodes: list[Node]) -> QuotaStatus:
        totals = {CORES: 0.0, MEMORY: 0.0}
        for nd in nodes:
            v = node_capacity_vector(nd, self.registry)
            totals[CORES] += v[res.CPU] / 1000.0
            totals[MEMORY] += float(v[res.MEMORY])
            for name, slot in self.registry.slots.items():
                totals[name] = totals.get(name, 0.0) + float(v[slot])
        return QuotaStatus(totals)

    def status_from_encoded(self, enc) -> QuotaStatus:
        """Vectorized totals straight off the encoded snapshot — one masked sum
        over enc.nodes.cap instead of a per-node Python loop (hot path: called
        from the orchestrator and planner every loop)."""
        from kubernetes_autoscaler_tpu_torch.ops.hostfetch import to_host

        cap = to_host(enc.nodes.cap, dtype=np.int64)
        valid = to_host(enc.nodes.valid)
        sums = cap[valid].sum(axis=0)
        totals = {
            CORES: float(sums[res.CPU]) / 1000.0,
            MEMORY: float(sums[res.MEMORY]),
        }
        for name, slot in self.registry.slots.items():
            totals[name] = float(sums[slot])
        return QuotaStatus(totals)

    def max_nodes_addable(self, status: QuotaStatus, template: Node,
                          wanted: int) -> int:
        """Cap a scale-up delta so no max-limit is exceeded (reference:
        orchestrator applyLimits → ComputeDelta/CheckDelta)."""
        v = node_capacity_vector(template, self.registry)
        per_node = {
            CORES: v[res.CPU] / 1000.0,
            MEMORY: float(v[res.MEMORY]),
        }
        for name, slot in self.registry.slots.items():
            per_node[name] = float(v[slot])
        allowed = wanted
        for name, per in per_node.items():
            if per <= 0:
                continue
            headroom = self.limiter.max_for(name) - status.totals.get(name, 0.0)
            allowed = min(allowed, int(max(headroom, 0) // per))
        return max(allowed, 0)

    def deduct(self, status: QuotaStatus, node: Node) -> None:
        """Subtract one node's capacity from the running totals."""
        v = node_capacity_vector(node, self.registry)
        status.totals[CORES] = status.totals.get(CORES, 0.0) - v[res.CPU] / 1000.0
        status.totals[MEMORY] = status.totals.get(MEMORY, 0.0) - float(v[res.MEMORY])
        for name, slot in self.registry.slots.items():
            status.totals[name] = status.totals.get(name, 0.0) - float(v[slot])

    def nodes_removable(self, status: QuotaStatus, node: Node) -> bool:
        """Would removing `node` violate a min-limit? (reference: min-quota
        tracker gating planner.go:160)."""
        v = node_capacity_vector(node, self.registry)
        checks = {CORES: v[res.CPU] / 1000.0, MEMORY: float(v[res.MEMORY])}
        for name, slot in self.registry.slots.items():
            checks[name] = float(v[slot])
        for name, per in checks.items():
            if status.totals.get(name, 0.0) - per < self.limiter.min_for(name):
                return False
        return True

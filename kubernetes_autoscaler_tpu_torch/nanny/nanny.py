"""Addon resizer ("nanny"): scale one workload's requests with cluster size.

Reference counterpart: addon-resizer/nanny/ — nanny_lib.go watches the node
count and patches the dependent Deployment when its resources drift outside a
tolerance from the linear formula base + extra×nodes (estimator.go).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ResourceEstimatorSpec:
    """base + extra_per_node, per resource (reference: nanny/estimator.go)."""

    base: dict[str, float] = field(default_factory=dict)        # cpu cores, memory bytes
    extra_per_node: dict[str, float] = field(default_factory=dict)
    # acceptance range ±% before patching (reference: --threshold)
    threshold_pct: float = 10.0


def estimate(spec: ResourceEstimatorSpec, node_count: int) -> dict[str, float]:
    out = {}
    for name in set(spec.base) | set(spec.extra_per_node):
        out[name] = spec.base.get(name, 0.0) + spec.extra_per_node.get(name, 0.0) * node_count
    return out


def needs_update(spec: ResourceEstimatorSpec, current: dict[str, float],
                 node_count: int) -> bool:
    """True when any resource is outside ±threshold of the estimate
    (reference: checkResource / shouldOverwriteResources)."""
    want = estimate(spec, node_count)
    for name, target in want.items():
        cur = current.get(name, 0.0)
        if target <= 0:
            if cur != 0:
                return True
            continue
        if abs(cur - target) / target * 100.0 > spec.threshold_pct:
            return True
    return False


class Nanny:
    """The watch loop body (reference: nanny_lib.go PollAPIServer)."""

    def __init__(self, spec: ResourceEstimatorSpec, patch_resources):
        self.spec = spec
        self.patch_resources = patch_resources  # (dict resources) -> None

    def poll_once(self, node_count: int, current: dict[str, float]) -> bool:
        if needs_update(self.spec, current, node_count):
            self.patch_resources(estimate(self.spec, node_count))
            return True
        return False

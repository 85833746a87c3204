"""PricingModel SPI + the simple linear model.

Reference counterpart: cloudprovider.PricingModel (cloud_provider.go:133 via
CloudProvider.Pricing(): `NodePrice(node, start, end)` and
`PodPrice(pod, start, end)`), consumed by the price expander
(expander/price/price.go) and exposed over externalgrpc
(protos/externalgrpc.proto PricingNodePrice/PricingPodPrice).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol

from kubernetes_autoscaler_tpu_torch.models.api import Node, Pod

_HOUR_S = 3600.0
_GIB = 1024.0 ** 3


class PricingModel(Protocol):
    def node_price(self, node: Node, start_s: float, end_s: float) -> float:
        """Theoretical cost of running `node` for [start_s, end_s)."""
        ...

    def pod_price(self, pod: Pod, start_s: float, end_s: float) -> float:
        """Theoretical minimum cost of running `pod`'s requests."""
        ...


@dataclass
class SimplePricingModel:
    """Linear per-resource-hour pricing (the shape of GCE's pricing model,
    cloudprovider/gce/pricing.go: base rate per core + per GiB + per GPU).
    Per-node flat premiums come via `group_price_per_node` so test fixtures
    with explicit per-group prices stay expressive."""

    cpu_per_core_hour: float = 0.033
    mem_per_gib_hour: float = 0.0045
    gpu_per_hour: float = 0.70
    gpu_resource: str = "nvidia.com/gpu"
    group_price_per_node: dict[str, float] | None = None

    def _hours(self, start_s: float, end_s: float) -> float:
        return max(end_s - start_s, 0.0) / _HOUR_S

    def _rate(self, cpu_cores: float, mem_bytes: float, gpus: float) -> float:
        return (cpu_cores * self.cpu_per_core_hour
                + (mem_bytes / _GIB) * self.mem_per_gib_hour
                + gpus * self.gpu_per_hour)

    def node_price(self, node: Node, start_s: float, end_s: float) -> float:
        cap = node.alloc_or_cap()
        return self._rate(
            float(cap.get("cpu", 0.0)),
            float(cap.get("memory", 0.0)),
            float(cap.get(self.gpu_resource, 0.0)),
        ) * self._hours(start_s, end_s)

    def pod_price(self, pod: Pod, start_s: float, end_s: float) -> float:
        req = pod.requests
        return self._rate(
            float(req.get("cpu", 0.0)),
            float(req.get("memory", 0.0)),
            float(req.get(self.gpu_resource, 0.0)),
        ) * self._hours(start_s, end_s)

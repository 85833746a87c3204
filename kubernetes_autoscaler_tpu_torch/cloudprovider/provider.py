"""CloudProvider SPI — the L1 boundary to node-group actuation.

Reference counterpart: cloudprovider/cloud_provider.go:117-166 (CloudProvider)
and :180+ (NodeGroup). The surface is kept verb-compatible so provider
implementations translate 1:1; everything above it (orchestrators, planner)
depends only on this module.

The reference ships 30+ provider implementations; this framework ships the
in-memory test provider (cloudprovider/test_provider.py — the reference's
cloudprovider/test used by all core tests and benchmarks) and the out-of-
process gRPC provider shape (cloudprovider/externalgrpc — see sidecar/), and
leaves cloud-specific REST adapters to integrators.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field

from kubernetes_autoscaler_tpu_torch.models.api import Node


class NodeGroupError(Exception):
    pass


@dataclass
class InstanceStatus:
    """Cloud instance state (reference: cloud_provider.go Instance/InstanceStatus)."""

    name: str
    state: str = "Running"       # Creating | Running | Deleting
    error_class: str = ""        # "" | OutOfResources | Other


@dataclass
class ResourceLimiter:
    """Cluster-wide min/max for cores, memory (MiB) and custom resources
    (reference: cloud_provider.go:240 ResourceLimiter; consumed by
    resourcequotas default provider)."""

    min_limits: dict[str, int] = field(default_factory=dict)
    max_limits: dict[str, int] = field(default_factory=dict)

    def max_for(self, name: str, default: int = 1 << 60) -> int:
        return self.max_limits.get(name, default)

    def min_for(self, name: str, default: int = 0) -> int:
        return self.min_limits.get(name, default)


@dataclass
class NodeGroupOptions:
    """Per-node-group autoscaling option overrides (reference:
    config.NodeGroupAutoscalingOptions via NodeGroup.GetOptions)."""

    scale_down_utilization_threshold: float | None = None
    scale_down_gpu_utilization_threshold: float | None = None
    scale_down_unneeded_time_s: float | None = None
    scale_down_unready_time_s: float | None = None
    max_node_provision_time_s: float | None = None
    zero_or_max_node_scaling: bool = False
    ignore_daemonsets_utilization: bool | None = None


class NodeGroup(abc.ABC):
    """One elastic set of identical nodes (reference: cloud_provider.go:180)."""

    @abc.abstractmethod
    def id(self) -> str: ...

    @abc.abstractmethod
    def min_size(self) -> int: ...

    @abc.abstractmethod
    def max_size(self) -> int: ...

    @abc.abstractmethod
    def target_size(self) -> int: ...

    @abc.abstractmethod
    def increase_size(self, delta: int) -> None:
        """Ask the cloud for delta more nodes (async; reference IncreaseSize)."""

    def atomic_increase_size(self, delta: int) -> None:
        """All-or-nothing variant (reference AtomicIncreaseSize,
        cloud_provider.go:198-204; default falls back to increase_size)."""
        self.increase_size(delta)

    @abc.abstractmethod
    def delete_nodes(self, nodes: list[Node]) -> None:
        """Delete specific nodes, decreasing target size (reference DeleteNodes)."""

    def force_delete_nodes(self, nodes: list[Node]) -> None:
        self.delete_nodes(nodes)

    @abc.abstractmethod
    def decrease_target_size(self, delta: int) -> None:
        """Lower target without deleting registered nodes (reference
        DecreaseTargetSize; delta < 0)."""

    @abc.abstractmethod
    def nodes(self) -> list[InstanceStatus]:
        """All instances, including creating/deleting ones."""

    @abc.abstractmethod
    def template_node_info(self) -> Node:
        """A sanitized template node for simulation (reference TemplateNodeInfo;
        sanitization mirrors simulator/node_info_utils.go SanitizedNodeInfo)."""

    def exist(self) -> bool:
        return True

    def create(self) -> "NodeGroup":
        raise NodeGroupError("node group auto-provisioning not supported")

    def delete(self) -> None:
        raise NodeGroupError("node group auto-provisioning not supported")

    def autoprovisioned(self) -> bool:
        return False

    def get_options(self, defaults: NodeGroupOptions) -> NodeGroupOptions:
        return defaults


class CloudProvider(abc.ABC):
    """Reference: cloud_provider.go:117."""

    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def node_groups(self) -> list[NodeGroup]: ...

    @abc.abstractmethod
    def node_group_for_node(self, node: Node) -> NodeGroup | None: ...

    def has_instance(self, node: Node) -> bool:
        return self.node_group_for_node(node) is not None

    def pricing(self):
        """Optional PricingModel (reference: cloud_provider.go:133)."""
        return None

    def get_resource_limiter(self) -> ResourceLimiter:
        return ResourceLimiter()

    def gpu_label(self) -> str:
        return "cloud.google.com/gke-accelerator"

    def gpu_resource_name(self) -> str:
        """The extended-resource name GPUs are requested under (reference:
        gpu.ResourceNvidiaGPU in utils/gpu)."""
        return "nvidia.com/gpu"

    def refresh(self) -> None:
        """Called before every RunOnce loop (reference Refresh)."""

    def cleanup(self) -> None:
        """Called on shutdown (reference Cleanup)."""

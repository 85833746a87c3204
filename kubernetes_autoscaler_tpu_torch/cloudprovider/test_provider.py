"""In-memory cloud provider for tests and benchmarks.

Reference counterpart: cloudprovider/test/test_cloud_provider.go — the
testprovider used across the reference's core tests and RunOnce benchmarks
(core/bench/benchmark_runonce_test.go:404-407: AddNodeGroup WithTemplate /
WithNGSize, onScaleUp/onScaleDown callbacks).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from kubernetes_autoscaler_tpu_torch.cloudprovider.provider import (
    CloudProvider,
    InstanceStatus,
    NodeGroup,
    NodeGroupError,
    NodeGroupOptions,
    ResourceLimiter,
)
from kubernetes_autoscaler_tpu_torch.models.api import Node


class TestNodeGroup(NodeGroup):
    __test__ = False  # fixture class, not a pytest case (collection warning)

    def __init__(
        self,
        gid: str,
        min_size: int,
        max_size: int,
        target: int,
        template: Node,
        provider: "TestCloudProvider",
        options: NodeGroupOptions | None = None,
        price_per_node: float = 1.0,
    ):
        self._id = gid
        self._min = min_size
        self._max = max_size
        self._target = target
        self._template = template
        self._provider = provider
        self._options = options
        self.price_per_node = price_per_node
        self._instances: list[InstanceStatus] = []
        self._exists = True
        self._autoprovisioned = False

    def id(self) -> str:
        return self._id

    def min_size(self) -> int:
        return self._min

    def max_size(self) -> int:
        return self._max

    def target_size(self) -> int:
        return self._target

    def increase_size(self, delta: int) -> None:
        if delta <= 0:
            raise NodeGroupError(f"increase_size: delta must be positive, got {delta}")
        if self._target + delta > self._max:
            raise NodeGroupError(
                f"increase_size: {self._target}+{delta} exceeds max {self._max}"
            )
        if self._provider.on_scale_up:
            self._provider.on_scale_up(self._id, delta)
        self._target += delta

    def delete_nodes(self, nodes: list[Node]) -> None:
        if self._target - len(nodes) < self._min:
            raise NodeGroupError("delete_nodes: would go below min size")
        for nd in nodes:
            self._remove_one(nd)

    def force_delete_nodes(self, nodes: list[Node]) -> None:
        """Forceful path: bypasses the min-size guard (reference
        ForceDeleteNodes bypasses termination protections)."""
        for nd in nodes:
            self._remove_one(nd)

    def _remove_one(self, nd: Node) -> None:
        if self._provider.on_scale_down:
            self._provider.on_scale_down(self._id, nd.name)
        self._provider.remove_node(self._id, nd.name)
        # deleting a never-registered instance clears its cloud-side
        # record too (otherwise a reaped create-error instance would be
        # re-reaped — and the target re-decremented — every loop)
        self._instances = [i for i in self._instances if i.name != nd.name]
        self._target -= 1

    def decrease_target_size(self, delta: int) -> None:
        if delta >= 0:
            raise NodeGroupError("decrease_target_size: delta must be negative")
        if self._target + delta < len(self._provider.nodes_of(self._id)):
            raise NodeGroupError("decrease_target_size: below registered node count")
        self._target += delta

    def nodes(self) -> list[InstanceStatus]:
        regs = [InstanceStatus(n) for n in self._provider.nodes_of(self._id)]
        return regs + list(self._instances)

    def add_unregistered_instance(self, name: str, state: str = "Creating",
                                  error_class: str = "") -> None:
        self._instances.append(InstanceStatus(name, state, error_class))

    def template_node_info(self) -> Node:
        t = self._template
        return Node(
            name=f"template-{self._id}",
            labels=dict(t.labels),
            capacity=dict(t.capacity),
            allocatable=dict(t.allocatable),
            taints=list(t.taints),
            ready=True,
        )

    def get_options(self, defaults: NodeGroupOptions) -> NodeGroupOptions:
        return self._options or defaults

    # ---- auto-provisioning lifecycle (reference: cloud_provider.go
    # Create/Delete/Autoprovisioned; test provider supports them for the
    # NodeGroupManager tests) ----

    def exist(self) -> bool:
        return self._exists

    def autoprovisioned(self) -> bool:
        return self._autoprovisioned

    def create(self) -> "TestNodeGroup":
        if self._exists:
            raise NodeGroupError(f"node group {self._id} already exists")
        if self._id in self._provider._groups:
            # a registered group with this id exists (this object is a stale
            # candidate) — never silently overwrite it
            raise NodeGroupError(f"node group {self._id} already registered")
        self._exists = True
        self._provider._groups[self._id] = self
        return self

    def delete(self) -> None:
        if not self._autoprovisioned:
            raise NodeGroupError(f"node group {self._id} is not autoprovisioned")
        if self._provider.nodes_of(self._id):
            raise NodeGroupError(f"node group {self._id} still has nodes")
        self._exists = False
        self._provider._groups.pop(self._id, None)


@dataclass
class TestCloudProvider(CloudProvider):
    __test__ = False  # fixture class, not a pytest case (collection warning)

    on_scale_up: Callable[[str, int], None] | None = None
    on_scale_down: Callable[[str, str], None] | None = None
    resource_limiter: ResourceLimiter = field(default_factory=ResourceLimiter)
    machine_templates: dict[str, tuple] = field(default_factory=dict)

    def __post_init__(self):
        self._groups: dict[str, TestNodeGroup] = {}
        self._node_to_group: dict[str, str] = {}

    def name(self) -> str:
        return "test"

    def add_node_group(
        self,
        gid: str,
        template: Node,
        min_size: int = 0,
        max_size: int = 1000,
        target: int = 0,
        options: NodeGroupOptions | None = None,
        price_per_node: float = 1.0,
    ) -> TestNodeGroup:
        g = TestNodeGroup(gid, min_size, max_size, target, template, self,
                          options, price_per_node)
        self._groups[gid] = g
        return g

    def add_node(self, gid: str, node: Node) -> None:
        self._node_to_group[node.name] = gid

    def remove_node(self, gid: str, node_name: str) -> None:
        self._node_to_group.pop(node_name, None)

    def nodes_of(self, gid: str) -> list[str]:
        return [n for n, g in self._node_to_group.items() if g == gid]

    def node_groups(self) -> list[NodeGroup]:
        return list(self._groups.values())

    def node_group_for_node(self, node: Node) -> NodeGroup | None:
        gid = self._node_to_group.get(node.name)
        return self._groups.get(gid) if gid else None

    def get_resource_limiter(self) -> ResourceLimiter:
        return self.resource_limiter

    def pricing(self):
        """A linear PricingModel (reference: testprovider's PricingModel).
        Per-group flat prices remain visible through group_price_per_node."""
        from kubernetes_autoscaler_tpu_torch.cloudprovider.pricing import (
            SimplePricingModel,
        )

        return SimplePricingModel(group_price_per_node={
            gid: g.price_per_node for gid, g in self._groups.items()
        })

    # ---- machine catalog for auto-provisioning (reference:
    # GetAvailableMachineTypes + NewNodeGroup, cloud_provider.go:128-131) ----

    def add_machine_type(self, name: str, template: Node,
                         price_per_node: float = 1.0) -> None:
        self.machine_templates[name] = (template, price_per_node)

    def get_available_machine_types(self) -> list[str]:
        return list(self.machine_templates)

    def new_node_group(self, machine_type: str, max_size: int = 1000) -> TestNodeGroup:
        """A candidate group that does not exist until create() is called."""
        if machine_type not in self.machine_templates:
            raise NodeGroupError(f"unknown machine type {machine_type}")
        template, price = self.machine_templates[machine_type]
        g = TestNodeGroup(f"autoprovisioned-{machine_type}", 0, max_size, 0,
                          template, self, None, price)
        g._exists = False
        g._autoprovisioned = True
        return g

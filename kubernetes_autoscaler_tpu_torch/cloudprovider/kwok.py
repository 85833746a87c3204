"""Hollow-node scale-test cluster: the kwok/kubemark analog.

Reference counterparts: cloudprovider/kwok (nodes simulated by KWOK inside a
real cluster — scale testing without VMs) and the kubemark hollow-node
harness (proposals/scalability_tests.md:18-25 — 1000 hollow nodes hosting the
GA scale claim of 1000 nodes x 30 pods/node, FAQ.md:148).

`KwokCluster` extends the in-memory FakeCluster with the lifecycle realism
those harnesses provide:

  * boot latency — a scale-up creates cloud instances in `Creating` state;
    they register as NotReady nodes only after `boot_delay_s`;
  * readiness latency — registered nodes turn Ready after `ready_delay_s`
    (exercises ClusterStateRegistry readiness gating and upcoming-node math);
  * boot failures — `fail_next(gid, n)` scripts the next n instances of a
    group to end in a create-error state instead of registering (exercises
    the deleteCreatedNodesWithErrors reaping + group backoff path);
  * hollow pods — `saturate(pods_per_node)` binds filler pods to every
    registered node, the kubemark load shape.

Time is driven by `advance_to(now)`, same as FakeCluster.
"""

from __future__ import annotations

from dataclasses import dataclass

from kubernetes_autoscaler_tpu_torch.models.api import Node, Pod
from kubernetes_autoscaler_tpu_torch.utils.fakecluster import FakeCluster
from kubernetes_autoscaler_tpu_torch.utils.testing import build_test_pod


@dataclass
class _HollowInstance:
    name: str
    group_id: str
    created_at: float
    fail: bool
    registered_at: float | None = None  # set once the node object exists


class KwokCluster(FakeCluster):
    def __init__(self, boot_delay_s: float = 0.0, ready_delay_s: float = 0.0):
        super().__init__()
        self.boot_delay_s = boot_delay_s
        self.ready_delay_s = ready_delay_s
        self._hollow: list[_HollowInstance] = []
        self._fail_budget: dict[str, int] = {}

    # ---- failure scripting ----

    def fail_next(self, gid: str, count: int) -> None:
        """The next `count` instances created in `gid` fail to boot."""
        self._fail_budget[gid] = self._fail_budget.get(gid, 0) + count

    # ---- cloud callback override: instances, not instant nodes ----

    def _on_scale_up(self, gid: str, delta: int) -> None:
        g = next(x for x in self.provider.node_groups() if x.id() == gid)
        for _ in range(delta):
            name = f"{gid}-hollow-{next(self._seq)}"
            fail = self._fail_budget.get(gid, 0) > 0
            if fail:
                self._fail_budget[gid] -= 1
            self._hollow.append(_HollowInstance(name, gid, self._now, fail))
            g.add_unregistered_instance(
                name, state="Creating",
                error_class="OutOfResources" if fail else "")
        # failures surface on the instance immediately (cloud API reports the
        # create error); healthy instances register after boot_delay_s

    def _on_scale_down(self, gid: str, node_name: str) -> None:
        self._hollow = [h for h in self._hollow if h.name != node_name]
        super()._on_scale_down(gid, node_name)

    # ---- time ----

    def advance_to(self, now: float) -> None:
        self._now = now
        for h in self._hollow:
            if h.fail:
                continue
            g = next(x for x in self.provider.node_groups() if x.id() == h.group_id)
            if h.registered_at is None and now >= h.created_at + self.boot_delay_s:
                # register at the LOGICAL boot time so a single large time
                # jump can register and ready the node in one tick
                h.registered_at = h.created_at + self.boot_delay_s
                t = g.template_node_info()
                nd = Node(
                    name=h.name,
                    labels={**t.labels, "kubernetes.io/hostname": h.name},
                    capacity=dict(t.capacity),
                    allocatable=dict(t.allocatable),
                    taints=list(t.taints),
                    ready=now >= h.registered_at + self.ready_delay_s,
                )
                self.nodes[h.name] = nd
                self.provider.add_node(h.group_id, nd)
                g._instances = [i for i in g._instances if i.name != h.name]
            elif (h.registered_at is not None
                  and now >= h.registered_at + self.ready_delay_s):
                self.nodes[h.name].ready = True
        super().advance_to(now)

    # ---- kubemark load shape ----

    def saturate(self, pods_per_node: int, cpu_milli: int = 100,
                 mem_mib: int = 128) -> None:
        """Bind `pods_per_node` hollow pods to every registered node."""
        for nd in list(self.nodes.values()):
            for j in range(pods_per_node):
                p = build_test_pod(
                    f"hollow-{nd.name}-{j}", cpu_milli=cpu_milli,
                    mem_mib=mem_mib, owner_name=f"hollow-rs-{j % 10}",
                    node_name=nd.name)
                p.phase = "Running"
                self.add_pod(p)

"""FakeCluster: in-memory kube-world for integration tests.

Reference counterpart: test/integration/utils.go:58-88 FakeSet — bundles a
fake clientset, fake cloud provider and pod observer so a whole
StaticAutoscaler.RunOnce runs against memory. Here the fake wires the
TestCloudProvider callbacks to node lifecycle: increase_size materializes
ready nodes from the group template after `provision_delay_s`; delete removes
them; evictions unbind pods.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

from kubernetes_autoscaler_tpu_torch.cloudprovider.test_provider import TestCloudProvider
from kubernetes_autoscaler_tpu_torch.models.api import Node, Pod


@dataclass
class _PendingProvision:
    group_id: str
    count: int
    at: float


class FakeCluster:
    """ClusterDataSource + EvictionSink + cloud-side node lifecycle."""

    def __init__(self, provision_delay_s: float = 0.0):
        self.provider = TestCloudProvider(
            on_scale_up=self._on_scale_up,
            on_scale_down=self._on_scale_down,
        )
        self.nodes: dict[str, Node] = {}
        self.pods: dict[str, Pod] = {}
        self.pdbs: list = []
        self.workloads: list = []
        self.provreqs: list = []
        self.capacity_buffers: list = []
        self._dra = None
        self._csi = None
        self.provision_delay_s = provision_delay_s
        self.evicted: list[str] = []
        self.eviction_graces: dict[str, float | None] = {}
        self.namespace_labels: dict[str, dict[str, str]] = {}
        self._pending: list[_PendingProvision] = []
        self._seq = itertools.count()
        self._now = 0.0

    # ---- time control ----

    def advance_to(self, now: float) -> None:
        self._now = now
        still = []
        for p in self._pending:
            if now >= p.at:
                self._materialize(p.group_id, p.count)
            else:
                still.append(p)
        self._pending = still

    # ---- cloud callbacks ----

    def _on_scale_up(self, gid: str, delta: int) -> None:
        if self.provision_delay_s <= 0:
            self._materialize(gid, delta)
        else:
            self._pending.append(
                _PendingProvision(gid, delta, self._now + self.provision_delay_s)
            )

    def _materialize(self, gid: str, count: int) -> None:
        g = next(x for x in self.provider.node_groups() if x.id() == gid)
        for _ in range(count):
            t = g.template_node_info()
            name = f"{gid}-node-{next(self._seq)}"
            nd = Node(
                name=name,
                labels={**t.labels, "kubernetes.io/hostname": name},
                capacity=dict(t.capacity),
                allocatable=dict(t.allocatable),
                taints=list(t.taints),
                ready=True,
            )
            self.nodes[name] = nd
            self.provider.add_node(gid, nd)

    def _on_scale_down(self, gid: str, node_name: str) -> None:
        self.nodes.pop(node_name, None)
        for p in self.pods.values():
            if p.node_name == node_name:
                p.node_name = ""
                p.phase = "Pending"

    # ---- ClusterDataSource ----

    def list_nodes(self) -> list[Node]:
        return list(self.nodes.values())

    def list_pods(self) -> list[Pod]:
        return list(self.pods.values())

    def list_namespaces(self) -> dict[str, dict[str, str]]:
        """Namespace name -> labels (affinity namespaceSelector support)."""
        return dict(self.namespace_labels)

    def list_pdbs(self) -> list:
        """Effective budgets, the way the API server maintains
        status.disruptionsAllowed: the configured allowance minus matching
        pods currently disrupted (evicted and not yet Running again)."""
        from dataclasses import replace

        out = []
        for pdb in self.pdbs:
            disrupted = sum(
                1 for p in self.pods.values()
                if pdb.matches(p) and p.phase != "Running"
            )
            out.append(replace(
                pdb,
                disruptions_allowed=max(pdb.disruptions_allowed - disrupted, 0),
            ))
        return out

    def add_pdb(self, pdb) -> None:
        self.pdbs.append(pdb)

    def list_workloads(self) -> list:
        return list(self.workloads)

    def add_workload(self, workload) -> None:
        self.workloads.append(workload)

    def list_capacity_buffers(self) -> list:
        return list(self.capacity_buffers)

    def add_capacity_buffer(self, buf) -> None:
        self.capacity_buffers.append(buf)

    def list_provisioning_requests(self) -> list:
        return list(self.provreqs)

    def add_provisioning_request(self, pr) -> None:
        self.provreqs.append(pr)

    def dra_snapshot(self):
        from kubernetes_autoscaler_tpu_torch.simulator.dynamicresources import (
            DraSnapshot,
        )

        if self._dra is None:
            self._dra = DraSnapshot()
        return self._dra

    def csi_snapshot(self):
        from kubernetes_autoscaler_tpu_torch.simulator.csi import CsiSnapshot

        if self._csi is None:
            self._csi = CsiSnapshot()
        return self._csi

    # ---- EvictionSink ----

    def evict(self, pod: Pod, node: Node,
              grace_period_s: float | None = None) -> None:
        self.evicted.append(pod.name)
        self.eviction_graces[pod.name] = grace_period_s
        live = self.pods.get(f"{pod.namespace}/{pod.name}")
        if live is not None:
            live.node_name = ""
            live.phase = "Pending"
        # eviction releases DRA claim reservations; claims nobody holds
        # deallocate so their devices free up (reference: drain path
        # unreserving claims through the DRA snapshot)
        if self._dra is not None:
            self._dra.release(pod)

    # ---- fixture helpers ----

    def add_node_group(self, gid: str, template: Node, **kw):
        return self.provider.add_node_group(gid, template, **kw)

    def add_existing_node(self, gid: str, node: Node) -> None:
        self.nodes[node.name] = node
        self.provider.add_node(gid, node)
        g = next(x for x in self.provider.node_groups() if x.id() == gid)
        g._target = max(g._target, len(self.provider.nodes_of(gid)))

    def add_pod(self, pod: Pod) -> None:
        self.pods[f"{pod.namespace}/{pod.name}"] = pod

    def remove_pod(self, name: str, namespace: str = "default") -> None:
        self.pods.pop(f"{namespace}/{name}", None)

    def bind(self, pod_name: str, node_name: str, namespace: str = "default") -> None:
        p = self.pods[f"{namespace}/{pod_name}"]
        p.node_name = node_name
        p.phase = "Running"

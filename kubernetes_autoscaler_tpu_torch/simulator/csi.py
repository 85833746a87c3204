"""CSI volume-limit tracking on the tensor plane.

Reference counterpart: simulator/csi/ (269 LoC, flag-gated — SURVEY.md §2.3):
a fork/commit/revert snapshot of CSINode objects so the scheduler's volume-
limits filter sees simulated attach counts.

TPU re-design: same lowering pattern as DRA — each CSI driver's attachable
volume limit becomes an extended-resource slot ("csi/<driver>"): node
capacity = the driver's allocatable count from CSINode, pod request = how
many of the pod's PVCs that driver serves. The volume-limits predicate then
IS the resource-fit comparison; fork/commit/revert ride the pytree snapshot.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kubernetes_autoscaler_tpu_torch.models.api import Node, Pod

CSI_RESOURCE_PREFIX = "csi/"


@dataclass
class CSINodeDriver:
    name: str
    allocatable_count: int = 0      # max attachable volumes (0 = unlimited)


@dataclass
class CSINode:
    """reference: storage.k8s.io CSINode, joined into framework.NodeInfo
    (infos.go:57-68)."""

    node_name: str
    drivers: list[CSINodeDriver] = field(default_factory=list)


@dataclass
class CsiSnapshot:
    csi_nodes: dict[str, CSINode] = field(default_factory=dict)
    # pvc (namespace/name) -> driver name, from PV/StorageClass resolution
    pvc_driver: dict[str, str] = field(default_factory=dict)

    def add(self, csi_node: CSINode) -> None:
        self.csi_nodes[csi_node.node_name] = csi_node

def apply_csi(nodes: list[Node], pods: list[Pod], csi: CsiSnapshot):
    """Lower volume limits into the resource axis before encode_cluster.

    Like apply_dra, previously-lowered state is CLEARED first so removed
    CSINodes/PVC mappings leave no phantom limits on the persistent
    objects."""
    clear_csi_lowering(nodes, pods)
    drivers_seen: set[str] = set()
    for nd in nodes:
        cn = csi.csi_nodes.get(nd.name)
        if cn is None:
            continue
        for d in cn.drivers:
            if d.allocatable_count <= 0:
                continue
            key = CSI_RESOURCE_PREFIX + d.name
            nd.capacity[key] = d.allocatable_count
            if nd.allocatable:
                nd.allocatable[key] = d.allocatable_count
            drivers_seen.add(d.name)

    # A PVC mounted by several pods occupies ONE attachment on a node, not
    # one per pod (the scheduler's volume-limits filter counts unique
    # volumes). The dense per-pod lowering can't express sharing, so the
    # FIRST referencing pod carries the charge and the rest go through the
    # host-check tier (the same exactness pattern as shared DRA claims).
    from kubernetes_autoscaler_tpu_torch.models.api import HOST_CHECK_ANNOTATION

    pvc_owners: dict[str, str] = {}
    pvc_refcount: dict[str, int] = {}
    for pod in pods:
        for ref in pod.pvc_refs:
            key = ref if "/" in ref else f"{pod.namespace}/{ref}"
            pvc_refcount[key] = pvc_refcount.get(key, 0) + 1
            pvc_owners.setdefault(key, pod.name)

    for pod in pods:
        per_driver: dict[str, int] = {}
        lossy = False
        for ref in pod.pvc_refs:
            key = ref if "/" in ref else f"{pod.namespace}/{ref}"
            driver = csi.pvc_driver.get(key)
            if not driver:
                continue
            if pvc_refcount.get(key, 1) > 1:
                lossy = True
                if pvc_owners.get(key) != pod.name:
                    continue  # a sibling already carries the attachment
            per_driver[driver] = per_driver.get(driver, 0) + 1
        # overwrite, not accumulate — the loop re-lists the same Pod objects
        # every tick and this pass must be idempotent
        for driver, n in per_driver.items():
            if driver in drivers_seen:
                pod.requests[CSI_RESOURCE_PREFIX + driver] = n
        if lossy:
            from kubernetes_autoscaler_tpu_torch.models.api import (
                CSI_LOSSY_ANNOTATION,
            )

            pod.annotations[HOST_CHECK_ANNOTATION] = "true"
            pod.annotations[CSI_LOSSY_ANNOTATION] = "true"


    from kubernetes_autoscaler_tpu_torch.models.api import CSI_LOSSY_ANNOTATION
    from kubernetes_autoscaler_tpu_torch.simulator.dynamicresources import (
        lowering_fingerprint,
    )

    return lowering_fingerprint(nodes, pods, CSI_RESOURCE_PREFIX,
                                (CSI_LOSSY_ANNOTATION,))


def clear_csi_lowering(nodes: list[Node], pods: list[Pod]) -> None:
    """Remove everything a previous apply_csi pass wrote."""
    from kubernetes_autoscaler_tpu_torch.models.api import (
        CSI_LOSSY_ANNOTATION,
        DRA_LOSSY_ANNOTATION,
        HOST_CHECK_ANNOTATION,
    )
    from kubernetes_autoscaler_tpu_torch.simulator.dynamicresources import (
        clear_prefixed_resources,
    )

    clear_prefixed_resources(nodes, pods, CSI_RESOURCE_PREFIX)
    for p in pods:
        if p.annotations.pop(CSI_LOSSY_ANNOTATION, None) is not None \
                and DRA_LOSSY_ANNOTATION not in p.annotations:
            p.annotations.pop(HOST_CHECK_ANNOTATION, None)

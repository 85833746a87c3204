"""Test fixture builders, mirroring the reference's utils/test idiom
(cluster-autoscaler/utils/test/test_utils.go: BuildTestNode, BuildTestPod,
SetNodeReadyState — used across every core test)."""

from __future__ import annotations

from kubernetes_autoscaler_tpu_torch.models.api import (
    Node,
    OwnerRef,
    Pod,
    Taint,
    Toleration,
)

_MIB = 1024 * 1024


def build_test_node(
    name: str,
    cpu_milli: int = 1000,
    mem_mib: int = 2048,
    pods: int = 110,
    labels: dict[str, str] | None = None,
    taints: list[Taint] | None = None,
    zone: str = "",
    ready: bool = True,
    gpus: int = 0,
    gpu_resource: str = "nvidia.com/gpu",
) -> Node:
    lbl = {"kubernetes.io/hostname": name}
    if zone:
        lbl["topology.kubernetes.io/zone"] = zone
    if labels:
        lbl.update(labels)
    cap: dict[str, float] = {
        "cpu": cpu_milli / 1000.0,
        "memory": mem_mib * _MIB,
        "pods": pods,
    }
    if gpus:
        cap[gpu_resource] = gpus
    return Node(
        name=name,
        labels=lbl,
        capacity=dict(cap),
        allocatable=dict(cap),
        taints=list(taints or []),
        ready=ready,
    )


def build_test_pod(
    name: str,
    cpu_milli: int = 100,
    mem_mib: int = 128,
    namespace: str = "default",
    node_name: str = "",
    labels: dict[str, str] | None = None,
    node_selector: dict[str, str] | None = None,
    tolerations: list[Toleration] | None = None,
    owner_kind: str = "ReplicaSet",
    owner_name: str = "",
    gpus: int = 0,
    gpu_resource: str = "nvidia.com/gpu",
    host_port: int = 0,
    priority: int = 0,
) -> Pod:
    req: dict[str, float] = {}
    if cpu_milli:
        req["cpu"] = cpu_milli / 1000.0
    if mem_mib:
        req["memory"] = mem_mib * _MIB
    if gpus:
        req[gpu_resource] = gpus
    owner = None
    if owner_kind:
        oname = owner_name or f"{name}-owner"
        owner = OwnerRef(kind=owner_kind, name=oname, uid=f"uid-{oname}")
    return Pod(
        name=name,
        namespace=namespace,
        uid=f"uid-{namespace}/{name}",
        labels=dict(labels or {}),
        requests=req,
        node_selector=dict(node_selector or {}),
        tolerations=list(tolerations or []),
        owner=owner,
        node_name=node_name,
        host_ports=((host_port, "TCP"),) if host_port else (),
        priority=priority,
        phase="Running" if node_name else "Pending",
    )


def replicate(pod_factory, count: int, prefix: str):
    """count pods sharing one controller (one equivalence group)."""
    pods = []
    for i in range(count):
        p = pod_factory(f"{prefix}-{i}")
        pods.append(p)
    return pods

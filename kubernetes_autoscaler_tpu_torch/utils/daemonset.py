"""DaemonSet overhead for simulated new nodes.

Reference counterpart: utils/daemonset/daemonset.go:39
GetDaemonSetPodsForNode — template NodeInfos are built WITH their matching
DaemonSet pods (simulator/node_info_utils.go:45,63 threads `daemonsets`
into every sanitized template), so binpacking charges DS cpu/mem on every
simulated new node. Without this, a cluster whose nodes each run 10-20% of
logging/monitoring agents over-estimates fresh-node capacity and
systematically under-provisions.

DaemonSets ride the Workload seam (kind == "DaemonSet", template = the DS
pod spec) — the same lister-shaped source podinjection already consumes.
"""

from __future__ import annotations

import numpy as np

from kubernetes_autoscaler_tpu_torch.models import resources as res
from kubernetes_autoscaler_tpu_torch.models.api import Node, Pod


def daemonset_pods_for_node(node: Node, workloads: list) -> list[Pod]:
    """The DS pods that would run on `node` (reference:
    daemon.NodeShouldRunDaemonPod via GetDaemonSetPodsForNode): node
    selector/affinity must match and the node's hard taints must be
    tolerated. The DS controller itself schedules regardless of free
    capacity (it uses its own tolerations for unschedulable/not-ready), so
    no resource-fit gate here — the charge is what the pod REQUESTS."""
    from kubernetes_autoscaler_tpu_torch.utils import oracle

    out: list[Pod] = []
    for w in workloads:
        if getattr(w, "kind", "") != "DaemonSet" or w.template is None:
            continue
        p = w.template
        if not oracle.selector_matches(p, node):
            continue
        if not oracle.taints_tolerated(p, node):
            continue
        out.append(p)
    return out


def daemonset_overhead(
    template: Node,
    workloads: list,
    registry: res.ExtendedResourceRegistry,
) -> np.ndarray:
    """Summed request vector (int32[R]) of the DS pods a fresh node stamped
    from `template` would immediately carry. Subtracted from the group
    capacity row at encode time (models/encode.encode_node_groups) and
    charged as initial allocation on injected template nodes."""
    from kubernetes_autoscaler_tpu_torch.models.encode import pod_request_vector

    total = np.zeros((res.NUM_RESOURCES,), np.int32)
    for p in daemonset_pods_for_node(template, workloads):
        req, _lossy = pod_request_vector(p, registry)
        total += req
    return total

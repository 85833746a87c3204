"""Per-node utilization for scale-down eligibility.

Counterpart of the reference package's `ops/utilization.py`
(node_utilization, eligible_for_scale_down): dominant-resource utilization
(max of cpu and memory ratios) and the threshold screen on it.
"""

from __future__ import annotations

import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import NodeTensors
from kubernetes_autoscaler_tpu_torch.models.resources import CPU, MEMORY


def node_utilization(nodes: NodeTensors) -> torch.Tensor:
    """f32[N] dominant-resource utilization in [0, 1]; 0 on padding rows."""
    cap = nodes.cap.to(torch.float32)
    alloc = nodes.alloc.to(torch.float32)
    ratio = alloc / torch.clamp(cap, min=1.0)
    util = torch.maximum(ratio[:, CPU], ratio[:, MEMORY])
    return torch.where(nodes.valid, util, 0.0)


def eligible_for_scale_down(nodes: NodeTensors,
                            threshold: float | torch.Tensor) -> torch.Tensor:
    """bool[N]: utilization below `threshold` (a scalar or f32[N]) on a
    valid, ready node."""
    util = node_utilization(nodes)
    return nodes.valid & nodes.ready & (util < threshold)

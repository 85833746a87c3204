"""Per-node utilization for scale-down eligibility.

Counterpart of the reference package's `ops/utilization.node_utilization`:
dominant-resource utilization (max of cpu and memory ratios).
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

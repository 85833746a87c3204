"""Binpacking node estimation: every node group's expansion option at once.

Counterpart of the reference package's `ops/binpack.py` (EstimateResult,
estimate_all) for the unconstrained, single-device case. Each node group
gets a pool of `max_new_nodes` identical empty template bins (those past the
group's `max_new` closed); one launch of the batched pack kernel packs every
pending group into every pool, one batch row per option.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    Dims,
    NodeGroupTensors,
    PodGroupTensors,
    _Tree,
)
from kubernetes_autoscaler_tpu_torch.ops import predicates
from kubernetes_autoscaler_tpu_torch.ops.kernels.pack_kernel import (
    pack_groups_batched,
)
from kubernetes_autoscaler_tpu_torch.ops.pack import ffd_order


@dataclass(frozen=True)
class EstimateResult(_Tree):
    node_count: torch.Tensor     # i32[NG] new nodes each expansion option needs
    scheduled: torch.Tensor      # i32[NG, G] pods of group g the option schedules
    pods_per_node: torch.Tensor  # i32[NG, M] pods landing on each new node
    free_after: torch.Tensor     # i32[NG, M, R] leftover capacity
    template_fits: torch.Tensor  # bool[NG, G] exemplar passes template predicates


def option_pack_inputs(specs: PodGroupTensors, groups: NodeGroupTensors,
                       dims: Dims, max_new_nodes: int):
    """The arguments `estimate_all` hands the batched pack, plus the
    template mask: ((free, mask, req, count, order, limit_one), mask_gt).
    Batch row = option, bins = `max_new_nodes` empty template nodes."""
    tmpl_nodes = groups.as_node_tensors(dims)
    # bool[G, NG]: placement-independent predicates vs each template
    mask_gt = predicates.feasibility_mask(tmpl_nodes, specs,
                                          check_resources=False)
    order = ffd_order(specs.req, specs.valid & (specs.count > 0))
    count = torch.where(specs.valid, specs.count, 0)
    ng, r = groups.cap.shape
    dev = groups.cap.device
    free3 = groups.cap[:, None, :].expand(ng, max_new_nodes, r).contiguous()
    bin_open = (torch.arange(max_new_nodes, dtype=torch.int32, device=dev)[None, :]
                < groups.max_new[:, None])
    mask3 = (mask_gt.T[:, :, None] & bin_open[:, None, :]).contiguous()  # bool[NG, G, M]
    return ((free3, mask3, specs.req, count, order, specs.one_per_node()),
            mask_gt)


def estimate_all(specs: PodGroupTensors, groups: NodeGroupTensors, dims: Dims,
                 max_new_nodes: int) -> EstimateResult:
    """Compute every node group's expansion option for the pending pod set."""
    pack_args, mask_gt = option_pack_inputs(specs, groups, dims, max_new_nodes)
    res = pack_groups_batched(*pack_args)
    pods_per_node = res.placed.sum(dim=1, dtype=torch.int32)     # [NG, M]
    node_count = (pods_per_node > 0).sum(dim=-1).to(torch.int32)
    node_count = torch.where(groups.valid, node_count, 0)
    return EstimateResult(
        node_count=node_count,
        scheduled=res.scheduled * groups.valid[:, None],
        pods_per_node=pods_per_node,
        free_after=res.free_after,
        template_fits=mask_gt.T,
    )

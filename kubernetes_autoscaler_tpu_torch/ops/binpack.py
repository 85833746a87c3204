"""Binpacking node estimation: every node group's expansion option at once.

Counterpart of the reference package's `ops/binpack.py` (EstimateResult,
estimate_all, _estimate_all_sharded). Each node group gets a pool of
`max_new_nodes` identical empty template bins (those past the group's
`max_new` closed); one launch of the batched pack kernel packs every
pending group into every pool, one batch row per option. With
topology-coupled constraints the options go through the constrained pack
instead (ops/constrained.py, one lane per option): every fresh bin carries
its template's zone, and the zone-level counts come from the real nodes.
With a device mesh (parallel/mesh.py) the options split over its pods
axis: each rank launches the batched pack kernel on its slice of options,
and the slices are gathered.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    AffinityPlanes,
    Dims,
    NodeGroupTensors,
    NodeTensors,
    PodGroupTensors,
    _Tree,
)
from kubernetes_autoscaler_tpu_torch.ops import predicates
from kubernetes_autoscaler_tpu_torch.ops.kernels.pack_kernel import (
    pack_groups_batched,
)
from kubernetes_autoscaler_tpu_torch.ops.pack import ffd_order
from kubernetes_autoscaler_tpu_torch.parallel.mesh import (
    PODS_AXIS,
    all_gather,
    axis_block,
    axis_size,
    map_leaves,
)


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
                 max_new_nodes: int, planes: AffinityPlanes | None = None,
                 nodes: NodeTensors | None = None,
                 with_constraints: bool = False, mesh=None) -> EstimateResult:
    """Compute every node group's expansion option for the pending pod set.

    `with_constraints` (with the resident `planes` over the real `nodes`)
    routes through the topology-coupled pack: fresh template bins inherit
    the template's zone, so zone-level spread counts and affinity
    satisfaction from the real cluster carry into the estimate.

    `mesh` shards the options over its pods axis (`_estimate_all_sharded`),
    equal to the unsharded estimate on every rank. As in the reference,
    the constrained tier comes first (its planes are node-indexed), and
    a node-group count that does not divide over the axis takes the
    unsharded estimate."""
    if with_constraints and planes is not None and nodes is not None:
        return _estimate_constrained(specs, groups, dims, max_new_nodes,
                                     planes, nodes)
    if mesh is not None and groups.ng % axis_size(mesh, PODS_AXIS) == 0:
        return _estimate_all_sharded(specs, groups, dims, max_new_nodes, mesh)
    return _estimate_options(specs, groups, dims, max_new_nodes)


def _estimate_options(specs: PodGroupTensors, groups: NodeGroupTensors,
                      dims: Dims, max_new_nodes: int) -> EstimateResult:
    """Every option of `groups` in one launch of the batched pack."""
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


def _estimate_all_sharded(specs: PodGroupTensors, groups: NodeGroupTensors,
                          dims: Dims, max_new_nodes: int,
                          mesh) -> EstimateResult:
    """The options sharded over the mesh's pods axis, with no traffic
    between ranks until the end: each rank packs its block of node groups
    against the whole pending set (K1 on the card, one launch), and the
    blocks are gathered over the pods axis. The nodes axis is left
    replicated: template bins are per-option scratch, not cluster nodes."""
    blk = axis_block(mesh, PODS_AXIS, groups.ng)
    local = _estimate_options(specs, map_leaves(groups, lambda x: x[blk]),
                              dims, max_new_nodes)
    return map_leaves(local, lambda x: all_gather(x, mesh, PODS_AXIS))


def _estimate_constrained(specs: PodGroupTensors, groups: NodeGroupTensors,
                          dims: Dims, max_new_nodes: int,
                          planes: AffinityPlanes,
                          nodes: NodeTensors) -> EstimateResult:
    """Topology-aware expansion options, one lane of the constrained pack
    per option: every fresh bin carries the template's zone; resident-
    derived zone state and the hostname-domain minimum come from the real
    cluster."""
    from kubernetes_autoscaler_tpu_torch.ops.constrained import (
        BIG,
        GroupConstraints,
        pack_lanes,
        zone_agg,
    )

    z_dim = dims.max_zones
    m = max_new_nodes
    dev = groups.cap.device
    i32 = torch.int32
    (free0, mask, req, count, order, limit_one), mask_gt = option_pack_inputs(
        specs, groups, dims, max_new_nodes)

    # cluster-wide aggregates over REAL nodes
    sel_real = predicates.selector_match(nodes.label_hash, specs)      # [G, N]
    zval_real = nodes.zone_id > 0
    elig_host_real = sel_real & nodes.valid[None, :]
    s_elig_real = torch.where((specs.spread_kind == 2)[:, None],
                              elig_host_real & zval_real[None, :],
                              elig_host_real)
    cnt_zone = zone_agg(planes.spread_cnt, nodes.zone_id, z_dim)       # [G, Z]
    elig_zone = zone_agg(s_elig_real, nodes.zone_id, z_dim) > 0
    aff_zone = zone_agg(planes.aff_cnt, nodes.zone_id, z_dim)
    anti_zone = zone_agg(planes.anti_zone_cnt, nodes.zone_id, z_dim)
    min_host = torch.where(s_elig_real, planes.spread_cnt, BIG).amin(dim=1)

    # template-level static gates (a fresh node in the template's zone)
    tzc = groups.zone_id.clamp(0, z_dim - 1)                           # [NG]
    tval = groups.zone_id > 0
    tzl = tzc.long()
    gate = torch.where(tval[None, :], anti_zone[:, tzl], 0) == 0      # [G, NG]
    aff_ok_t = tval[None, :] & (aff_zone[:, tzl] > 0)
    need_static = (specs.aff_kind > 0) & ~specs.aff_self
    # hostname affinity (kind 1) is never resident-satisfied on a fresh
    # node; zone affinity needs a matching resident in the template's zone
    aff_gate = torch.where((specs.aff_kind == 2)[:, None], aff_ok_t, False)
    gate = gate & torch.where(need_static[:, None], aff_gate, True)
    zone_kinds = (specs.spread_kind == 2) | (specs.aff_kind == 2)
    gate = gate & torch.where(zone_kinds[:, None], tval[None, :], True)
    mask_gt = mask_gt & gate
    mask = (mask & gate.T[:, :, None]).contiguous()                   # [NG, G, M]
    sel_t = predicates.selector_match(groups.label_hash, specs).T      # [NG, G]

    # one lane per option: M bins, the first max_new of them open
    bin_open = (torch.arange(m, dtype=i32, device=dev)[None, :]
                < groups.max_new[:, None])                             # [NG, M]
    s_elig_bins = sel_t[:, :, None] & bin_open[:, None, :]
    s_elig_bins = (s_elig_bins & torch.where(
        (specs.spread_kind == 2)[None, :, None], tval[:, None, None],
        True)).contiguous()
    a_ok_bins = ((specs.aff_kind == 2)[None, :] & tval[:, None]
                 & (aff_zone[:, tzl].T > 0))[:, :, None].expand(
                     -1, -1, m).contiguous()
    zones = torch.arange(z_dim, dtype=tzc.dtype, device=dev)
    elig_zone_bins = elig_zone[None] | (
        (zones[None, :] == tzc[:, None])[:, None, :]
        & (sel_t & tval[:, None])[:, :, None]).contiguous()            # [NG, G, Z]
    cons = GroupConstraints(
        s_kind=specs.spread_kind[None], s_skew=specs.max_skew[None],
        s_self=specs.spread_self[None],
        s_cnt_node=torch.zeros((1, specs.g, m), dtype=i32, device=dev),
        s_elig=s_elig_bins,
        a_kind=specs.aff_kind[None], a_self=specs.aff_self[None],
        a_any=specs.aff_match_any[None], a_ok_node=a_ok_bins,
        anti_self_zone=specs.anti_self_zone[None],
        cnt_zone_base=cnt_zone[None], elig_zone_base=elig_zone_bins,
        min_host_base=min_host[None],
        zone_cl=tzc[:, None].expand(-1, m).contiguous(),
        zone_valid=tval[:, None].expand(-1, m).contiguous())
    res = pack_lanes(free0, mask, req, count, order, limit_one, cons, z_dim)
    pods_per_node = res.placed.sum(dim=1, dtype=i32)                   # [NG, M]
    node_count = (pods_per_node > 0).sum(dim=-1).to(i32)
    return EstimateResult(
        node_count=torch.where(groups.valid, node_count, 0),
        scheduled=res.scheduled * groups.valid[:, None],
        pods_per_node=pods_per_node,
        free_after=res.free_after,
        template_fits=mask_gt.T,
    )

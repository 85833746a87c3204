"""Topology-coupled placement: spread skew and inter-pod (anti-)affinity.

Counterpart of the reference package's `ops/constrained.py` (zone_onehot,
zone_agg, planes_static_mask, GroupConstraints, constraints_for_nodes,
place_group_constrained, pack_groups_constrained). Constraint state lives in
small per-domain count tensors: resident pods contribute through the
encoder's AffinityPlanes, and a group's own placements are tracked by a
loop of placement WAVES. Each wave computes, per domain, the remaining
allowance

    spread:    min(count over eligible domains) + max_skew - count[d]
    anti-self: 1 - placed[d]

clips the per-node first-fit counts by a within-zone prefix sum, places
globally in node-index order, updates the counts, and repeats until a wave
places nothing. A fixed point admits exactly what a serial one-pod-at-a-time
greedy would; waves only batch the order. The wave count is capped at
MAX_WAVES: placements beyond the cap are dropped, as in the reference (a
zone spread with maxSkew 1 over 3 zones places about 3 pods a wave).

Two entry points run B independent lanes at once, each its own node row:
`constrained_kernel.place_lanes` places one group a lane (the reference's
`place_group_constrained` under vmap: B = drain candidates), `pack_lanes`
the whole FFD group loop of a lane (`pack_groups_constrained` under vmap:
B = 1 for the filter pack, B = node groups for the expansion options),
constrained groups by waves and the others by the one-shot first fit, as
the reference's `lax.cond(is_con[g], slow, fast)` picks. On CUDA tensors
each is one launch of the hand-written kernel (csrc/constrained.cu): one
thread-block cluster a lane runs every wave of the lane and the host
reads nothing (the card's drain waves run inside the drain kernel). On
CPU tensors their plain versions run (ops/kernels/constrained_kernel.py):
a Python loop of waves over all lanes, a finished lane frozen with
`torch.where`, one "any lane active" flag read every WAVE_CHECK waves, and
one read per pack of which groups have a wave loop to run.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    AffinityPlanes,
    NodeTensors,
    PodGroupTensors,
    _Tree,
)
from kubernetes_autoscaler_tpu_torch.ops.pack import PackResult

BIG = 1 << 28
MAX_WAVES = 128
# the plain version's waves between two reads of the "any lane active"
# flag; a larger value trades reads for no-op waves after the last lane
# finishes, and changes no result
WAVE_CHECK = 2

I32 = torch.int32


def _zcl(zone_id: torch.Tensor, max_zones: int) -> torch.Tensor:
    return zone_id.clamp(0, max_zones - 1)


def zone_onehot(zone_id: torch.Tensor, max_zones: int) -> torch.Tensor:
    """bool[N, Z]; nodes without a zone label (id 0) are in no zone."""
    z = torch.arange(max_zones, dtype=zone_id.dtype, device=zone_id.device)
    oh = _zcl(zone_id, max_zones)[:, None] == z[None, :]
    return oh & (zone_id > 0)[:, None]


def zone_agg(plane_gn: torch.Tensor, zone_id: torch.Tensor,
             max_zones: int) -> torch.Tensor:
    """i32[G, Z]: per-zone totals of a per-node count plane. The reference's
    int32 matmul with the one-hot has no CUDA counterpart: an index_add over
    the zone axis sums the same integers."""
    vals = plane_gn.to(I32) * (zone_id > 0).to(I32)[None, :]
    out = torch.zeros((plane_gn.shape[0], max_zones), dtype=I32,
                      device=plane_gn.device)
    return out.index_add_(1, _zcl(zone_id, max_zones).long(), vals)


def planes_static_mask(specs: PodGroupTensors, planes: AffinityPlanes,
                       node_zone_id: torch.Tensor,
                       max_zones: int) -> torch.Tensor:
    """bool[G, N]: the resident-derived (placement-independent) part of the
    topology constraints — anti-affinity blocks, non-self positive-affinity
    satisfaction, and domain-presence requirements."""
    zcl = _zcl(node_zone_id, max_zones).long()
    has_zone = (node_zone_id > 0)[None, :]
    anti_zone_z = zone_agg(planes.anti_zone_cnt, node_zone_id, max_zones)
    aff_zone_z = zone_agg(planes.aff_cnt, node_zone_id, max_zones)

    ok = planes.anti_host_cnt == 0
    ok = ok & ~(has_zone & (anti_zone_z[:, zcl] > 0))
    kind = specs.aff_kind
    aff_ok = torch.where((kind == 1)[:, None], planes.aff_cnt > 0,
                         has_zone & (aff_zone_z[:, zcl] > 0))
    need_static = (kind > 0) & ~specs.aff_self
    ok = ok & torch.where(need_static[:, None], aff_ok, True)
    # zone-domain constraints need the node to HAVE a zone
    zone_kinds = (specs.spread_kind == 2) | (kind == 2)
    return ok & torch.where(zone_kinds[:, None], has_zone, True)


@dataclass(frozen=True)
class GroupConstraints(_Tree):
    """Per-group topology-constraint state over one destination node set.

    Built by `constraints_for_nodes` (real nodes) or inside the estimator
    (fresh template bins): leading dim G, node planes [G, N]. Gathered to
    lanes (`constrained_kernel.place_lanes`), the leading dim is the lane axis B instead, and
    `zone_cl` / `zone_valid` are [B or 1, N]."""

    s_kind: torch.Tensor          # i32[G] 0 none / 1 hostname / 2 zone
    s_skew: torch.Tensor          # i32[G]
    s_self: torch.Tensor          # bool[G] own placements count toward spread
    s_cnt_node: torch.Tensor      # i32[G, N] resident matching counts per node
    s_elig: torch.Tensor          # bool[G, N] node's domain eligible for the min
    a_kind: torch.Tensor          # i32[G]
    a_self: torch.Tensor          # bool[G]
    a_any: torch.Tensor           # bool[G] >=1 resident matches (first-pod gate)
    a_ok_node: torch.Tensor       # bool[G, N] satisfied-by-residents per node
    anti_self_zone: torch.Tensor  # bool[G] at most one of the group per zone
    cnt_zone_base: torch.Tensor   # i32[G, Z] spread counts per zone (residents)
    elig_zone_base: torch.Tensor  # bool[G, Z] zones eligible for the min
    min_host_base: torch.Tensor   # i32[G] min hostname-domain count OUTSIDE
                                  # this node set (BIG when it covers the world)
    zone_cl: torch.Tensor         # i32[N] clipped zone id per node (shared)
    zone_valid: torch.Tensor      # bool[N] node has a zone label

    def is_constrained(self) -> torch.Tensor:
        return (self.s_kind > 0) | (self.a_kind > 0) | self.anti_self_zone


def constraints_for_nodes(specs: PodGroupTensors, planes: AffinityPlanes,
                          nodes: NodeTensors, max_zones: int,
                          sel_mask: torch.Tensor | None = None
                          ) -> GroupConstraints:
    """Constraint state for packing onto the REAL node set."""
    from kubernetes_autoscaler_tpu_torch.ops import predicates

    sel = (predicates.selector_match(nodes.label_hash, specs)
           if sel_mask is None else sel_mask)
    zval = nodes.zone_id > 0
    zcl = _zcl(nodes.zone_id, max_zones)
    elig_host = sel & nodes.valid[None, :]
    s_elig = torch.where((specs.spread_kind == 2)[:, None],
                         elig_host & zval[None, :], elig_host)
    aff_zone_z = zone_agg(planes.aff_cnt, nodes.zone_id, max_zones)
    a_ok = torch.where((specs.aff_kind == 1)[:, None], planes.aff_cnt > 0,
                       zval[None, :] & (aff_zone_z[:, zcl.long()] > 0))
    return GroupConstraints(
        s_kind=specs.spread_kind, s_skew=specs.max_skew,
        s_self=specs.spread_self, s_cnt_node=planes.spread_cnt,
        s_elig=s_elig,
        a_kind=specs.aff_kind, a_self=specs.aff_self,
        a_any=specs.aff_match_any, a_ok_node=a_ok,
        anti_self_zone=specs.anti_self_zone,
        cnt_zone_base=zone_agg(planes.spread_cnt, nodes.zone_id, max_zones),
        elig_zone_base=zone_agg(s_elig, nodes.zone_id, max_zones) > 0,
        min_host_base=torch.full((specs.g,), BIG, dtype=I32,
                                 device=s_elig.device),
        zone_cl=zcl,
        zone_valid=zval,
    )


def place_group_constrained(free: torch.Tensor,       # i32[N, R]
                            feas_n: torch.Tensor,     # bool[N]
                            req: torch.Tensor,        # i32[R]
                            want: torch.Tensor,       # i32 scalar
                            limit_one: torch.Tensor,  # bool scalar
                            cons: GroupConstraints,   # gathered to one group
                            max_zones: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Wave-greedy placement of one constrained group; returns
    (free', place[N]). `cons` has the group's leading dim removed. One lane
    of `constrained_kernel.place_lanes`: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import constrained_kernel

    lane = GroupConstraints(**{k: v[None] for k, v in vars(cons).items()})
    dev = free.device
    free_out, place = constrained_kernel.place_lanes(
        free[None], feas_n[None], req[None],
        torch.as_tensor(want, dtype=I32, device=dev).reshape(1),
        torch.as_tensor(limit_one, dtype=torch.bool, device=dev).reshape(1),
        lane, max_zones)
    return free_out[0], place[0]


def pack_lanes(free: torch.Tensor,       # i32[B, N, R]
               mask: torch.Tensor,       # bool[B|1, G, N] full static feasibility
               req: torch.Tensor,        # i32[G, R]
               count: torch.Tensor,      # i32[G]
               order: torch.Tensor,      # i32[G]
               limit_one: torch.Tensor,  # bool[G]
               cons: GroupConstraints,   # fields [B or 1, G, ...]
               max_zones: int) -> PackResult:
    """First-fit-decreasing pack of every group into B independent node
    rows, topology-coupled groups through the wave placer, the others by
    the one-shot first fit (ops/pack.pack_groups' arithmetic): the
    reference's `pack_groups_constrained` under vmap. The kernel on CUDA
    tensors (one launch, `order` read on the card), its plain version on
    CPU tensors (ops/kernels/constrained_kernel.py)."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import constrained_kernel

    return constrained_kernel.pack_lanes(free, mask, req, count, order,
                                         limit_one, cons, max_zones)


def pack_groups_constrained(free: torch.Tensor,       # i32[N, R]
                            mask: torch.Tensor,       # bool[G, N]
                            req: torch.Tensor,        # i32[G, R]
                            count: torch.Tensor,      # i32[G]
                            order: torch.Tensor,      # i32[G]
                            limit_one: torch.Tensor,  # bool[G]
                            cons: GroupConstraints,
                            max_zones: int) -> PackResult:
    """First-fit-decreasing pack onto one node set with topology-coupled
    groups handled by the wave placer; unconstrained groups take the
    one-shot first-fit (identical to ops/pack.pack_groups)."""
    lanes = GroupConstraints(**{k: v[None] for k, v in vars(cons).items()})
    res = pack_lanes(free[None], mask[None], req, count, order, limit_one,
                     lanes, max_zones)
    return PackResult(free_after=res.free_after[0], placed=res.placed[0],
                      scheduled=res.scheduled[0])

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

One implementation, `place_lanes`, runs B independent lanes at once, each
its own group on its own node set: B = 1 for the filter pack, B = node
groups for the expansion options (the reference's vmap over options), B =
drain candidates (its vmap over candidates). A lane that has finished is
frozen with `torch.where`, as `while_loop` under `vmap` does. The host reads
one "any lane active" flag every WAVE_CHECK waves to end the loop; the
waves between two reads that find every lane finished change nothing, so
WAVE_CHECK changes no result.

The reference's `lax.cond(is_con[g], slow, fast)` is kept as a device-side
select between the wave placer and the one-shot first-fit: the host only
learns, from one read per pack (or per drain chunk), which wave loops have
an active lane at all, and runs no wave loop for the others (a group that
is not constrained, or has nothing to place, gets the first-fit result the
select would pick anyway).
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
from kubernetes_autoscaler_tpu_torch.ops.pack import PackResult, fit_count

BIG = 1 << 28
MAX_WAVES = 128
# waves between two reads of the "any lane active" flag; a larger value
# trades reads (each a device synchronisation) for no-op waves after the
# last lane finishes. 2 was the fastest of 1, 2, 4, 8 and 16 on an H100
# (PERF.md, the constrained step)
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
    lanes (`place_lanes`), the leading dim is the lane axis B instead, and
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


def _zone_segments(zone_cl: torch.Tensor, zone_valid: torch.Tensor,
                   max_zones: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(perm, seg), both i64[B or 1, N]: `perm` orders each row's nodes by
    zone, keyless nodes last, node order kept within a zone; `seg[i]` is the
    position in that order where sorted node i's zone begins."""
    key = torch.where(zone_valid, zone_cl.long(), max_zones)
    perm = torch.argsort(key, dim=1, stable=True)
    skey = key.gather(1, perm).contiguous()
    return perm, torch.searchsorted(skey, skey)


def place_lanes(free: torch.Tensor,       # i32[B, N, R]
                feas: torch.Tensor,       # bool[B, N] full feasibility
                req: torch.Tensor,        # i32[B, R]
                want: torch.Tensor,       # i32[B]
                limit_one: torch.Tensor,  # bool[B]
                cons: GroupConstraints,   # gathered to lanes
                max_zones: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Wave-greedy placement of B independent lanes, each one constrained
    group onto its own node row; returns (free', place i32[B, N]). The
    reference's `place_group_constrained` under vmap: a lane runs while it
    has pods left and its last wave placed some, for at most MAX_WAVES
    waves; a finished lane is frozen.

    The host reads the "any lane active" flag after every WAVE_CHECK waves
    (not before the first: callers run the loop only when a lane starts
    active). `place_lanes.waves` and `place_lanes.flag_reads` count the
    waves run and the flags read."""
    b, n, _ = free.shape
    dev = free.device
    node_ids = torch.arange(n, device=dev)
    perm, seg = _zone_segments(cons.zone_cl, cons.zone_valid, max_zones)
    perm, seg = perm.expand(b, n), seg.expand(b, n)
    zcl = cons.zone_cl.long().expand(b, n)
    zval = cons.zone_valid.expand(b, n)
    zval_i = zval.to(I32)
    # per-lane constants as columns
    lone = limit_one[:, None]
    a_kind = cons.a_kind[:, None]
    s_self = cons.s_self[:, None]
    skew = cons.s_skew[:, None]
    host_spread = (cons.s_kind == 1)[:, None]
    zone_spread = (cons.s_kind == 2)[:, None]
    anti_zone = cons.anti_self_zone[:, None]
    boot_kind = (cons.a_kind > 0) & cons.a_self & ~cons.a_any      # [B]

    free_c = free
    placed = torch.zeros((b, n), dtype=I32, device=dev)
    rem = want.to(I32)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for wave in range(MAX_WAVES):
        if wave and wave % WAVE_CHECK == 0:
            place_lanes.flag_reads += 1
            if not bool(((rem > 0) & ~done).any()):
                break
        place_lanes.waves += 1
        act = (rem > 0) & ~done
        fit = torch.minimum(fit_count(free_c, req), rem[:, None])
        fit = torch.where(feas, fit, 0)
        fit = torch.where(lone, torch.minimum(1 - (placed > 0).to(I32), fit),
                          fit)

        # --- positive affinity: resident-satisfied, self-opened, or bootstrap
        zone_placed = torch.zeros((b, max_zones), dtype=I32, device=dev)
        zone_placed.scatter_add_(1, zcl, placed * zval_i)             # [B, Z]
        open_zone = zval & (zone_placed.gather(1, zcl) > 0)
        dom_open = torch.where(a_kind == 1, placed > 0, open_zone)
        aff_ok = cons.a_ok_node | (cons.a_self[:, None] & dom_open)
        can = feas & (fit > 0)
        bootstrap = boot_kind & (placed.sum(dim=1) == 0)
        first = can.to(I32).argmax(dim=1)            # the first True, else 0
        boot_mask = (node_ids[None, :] == first[:, None]) \
            & can.any(dim=1)[:, None]
        aff_ok = torch.where(bootstrap[:, None], boot_mask,
                             torch.where(a_kind > 0, aff_ok, True))
        fit = torch.where(aff_ok, fit, 0)

        # --- hostname-domain spread: per-node allowance
        cnt_n = cons.s_cnt_node + torch.where(s_self, placed, 0)
        min_h = torch.minimum(torch.where(cons.s_elig, cnt_n, BIG).amin(dim=1),
                              cons.min_host_base)
        min_h = torch.where(min_h >= BIG, 0, min_h)
        allow_h = (min_h[:, None] + skew - cnt_n).clamp(min=0)
        fit = torch.where(host_spread, torch.minimum(fit, allow_h), fit)

        # --- zone-domain caps: spread allowance and/or anti-self 1-per-zone
        cnt_z = cons.cnt_zone_base + torch.where(s_self, zone_placed, 0)
        min_z = torch.where(cons.elig_zone_base, cnt_z, BIG).amin(dim=1)
        min_z = torch.where(min_z >= BIG, 0, min_z)
        allow_z = (min_z[:, None] + skew - cnt_z).clamp(min=0)
        zone_cap = torch.where(zone_spread, allow_z, BIG)
        zone_cap = torch.where(
            anti_zone, torch.minimum(zone_cap, (1 - zone_placed).clamp(min=0)),
            zone_cap)
        # what earlier nodes of the same zone take: an exclusive prefix sum
        # over the zone-ordered nodes, restarted at each zone
        fs = fit.gather(1, perm)
        ex = torch.cumsum(fs, dim=1, dtype=I32) - fs
        ex = ex - ex.gather(1, seg)
        excl = torch.empty_like(ex).scatter_(1, perm, ex)
        capped = (zone_cap.gather(1, zcl) - excl).clamp(min=0)
        # keyless nodes have no zone domain: uncapped by zone constraints
        fit_z = torch.where(zval, torch.minimum(fit, capped), fit)

        # --- global first-fit in node-index order
        cum = torch.cumsum(fit_z, dim=1, dtype=I32)
        place = torch.minimum((rem[:, None] - (cum - fit_z)).clamp(min=0), fit_z)
        place = torch.where(act[:, None], place, 0)
        n_placed = place.sum(dim=1, dtype=I32)
        free_c = free_c - place[:, :, None] * req[:, None, :]
        placed = placed + place
        rem = rem - n_placed
        done = done | (act & (n_placed == 0))
    return free_c, placed


place_lanes.waves = 0
place_lanes.flag_reads = 0


def place_group_constrained(free: torch.Tensor,       # i32[N, R]
                            feas_n: torch.Tensor,     # bool[N]
                            req: torch.Tensor,        # i32[R]
                            want: torch.Tensor,       # i32 scalar
                            limit_one: torch.Tensor,  # bool scalar
                            cons: GroupConstraints,   # gathered to one group
                            max_zones: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Wave-greedy placement of one constrained group; returns
    (free', place[N]). `cons` has the group's leading dim removed."""
    lane = GroupConstraints(**{k: v[None] for k, v in vars(cons).items()})
    dev = free.device
    free_out, place = place_lanes(
        free[None], feas_n[None], req[None],
        torch.as_tensor(want, dtype=I32, device=dev).reshape(1),
        torch.as_tensor(limit_one, dtype=torch.bool, device=dev).reshape(1),
        lane, max_zones)
    return free_out[0], place[0]


def _at_group(cons: GroupConstraints, g: int, b: int) -> GroupConstraints:
    """Lane view of group `g` of lane-batched constraints (each field
    [B or 1, G, ...]), expanded to B lanes."""
    fields = {}
    for k, v in vars(cons).items():
        if k in ("zone_cl", "zone_valid"):
            fields[k] = v
        else:
            x = v[:, g]
            fields[k] = x.expand((b,) + tuple(x.shape[1:]))
    return GroupConstraints(**fields)


def pack_lanes(free: torch.Tensor,       # i32[B, N, R]
               mask: torch.Tensor,       # bool[B, G, N] full static feasibility
               req: torch.Tensor,        # i32[G, R]
               count: torch.Tensor,      # i32[G]
               order: torch.Tensor,      # i32[G]
               limit_one: torch.Tensor,  # bool[G]
               cons: GroupConstraints,   # fields [B or 1, G, ...]
               max_zones: int) -> PackResult:
    """First-fit-decreasing pack of every group into B independent node
    rows, topology-coupled groups through the wave placer. One read of
    (order, which groups have a wave to run) per call; a group is then
    placed by the one-shot first-fit (ops/pack.pack_groups' arithmetic)
    and, where its wave loop has work, by the wave placer, the two joined
    by a device-side select on `is_constrained`."""
    b, n, r = free.shape
    g_total = req.shape[0]
    is_con = cons.is_constrained()                                 # [B|1, G]
    slow0 = is_con.any(dim=0) & (count > 0)
    order_h, slow_h = torch.stack([order.to(I32), slow0.to(I32)]).tolist()
    place_lanes.flag_reads += 1

    free_c = free
    placed = torch.zeros((b, g_total, n), dtype=I32, device=free.device)
    for g in order_h:
        reqg, cnt = req[g], count[g]
        c = fit_count(free_c, reqg)                                 # [B, N]
        c = torch.where(mask[:, g, :], c, 0)
        c = torch.where(limit_one[g], c.clamp(max=1), c)
        c = torch.minimum(c, cnt)
        cum = torch.cumsum(c, dim=1, dtype=I32)
        place = torch.minimum((cnt - (cum - c)).clamp(min=0), c)
        fast_free = free_c - place[:, :, None] * reqg
        if slow_h[g]:
            slow_free, slow_place = place_lanes(
                free_c, mask[:, g, :], reqg.expand(b, r), cnt.expand(b),
                limit_one[g].expand(b), _at_group(cons, g, b), max_zones)
            con = is_con[:, g]
            fast_free = torch.where(con[:, None, None], slow_free, fast_free)
            place = torch.where(con[:, None], slow_place, place)
        free_c = fast_free
        placed[:, g, :] = place
    return PackResult(free_after=free_c, placed=placed,
                      scheduled=placed.sum(dim=-1, dtype=I32))


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

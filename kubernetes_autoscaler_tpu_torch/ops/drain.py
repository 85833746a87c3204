"""Batched node-removal (drain) simulation for scale-down.

Counterpart of the reference package's `ops/drain.py` (RemovalResult,
simulate_removals). Every candidate node is simulated independently, in
chunks of candidates:

  1. its resident movable pods are gathered from a by-node sorted window and
     compacted into at most K per-group counts,
  2. a K-step first-fit places each group's count onto the destination
     nodes with the cumulative-fit trick (a Python loop over K on
     [C, N, R] tensors; the reference leaves this step to XLA),
  3. per-pod destinations are rebuilt from the groups' cumulative placement
     curves by `searchsorted`, one call per slot.

With `with_constraints` the re-placement is topology-aware: host-level
gates join the predicate plane, the candidate's own residents leave its
zone's counts before its pods are re-placed (the reference's ghost node),
and constrained groups re-place through the wave placer
(ops/constrained.place_lanes), the candidates of a chunk being its lanes
and `active` the (candidate, slot) lanes whose group is constrained and has
pods, so the sweep itself reads nothing to the host. Only the
gathered group of each (candidate, slot) is gated, as a [C, N] plane built
from [C, Z] adjusted zone counts; no [C, G, N] plane is formed.

A node with more than `max_groups_per_node` distinct shapes is reported
undrainable (its overflow pods count in n_failed). The chunk size changes
memory only, never results; by default it is worked out from
`CHUNK_BYTES` and the world's N and R (`default_chunk`).

`failure_reasons` is the lazy explanation pass over the candidates the
sweep reported undrainable: the same gather, compaction and first-fit
(steps 1-2), then which pod group found no destination, or why else the
node cannot drain (`RemovalReasons`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    AffinityPlanes,
    NodeTensors,
    PodGroupTensors,
    ScheduledPodTensors,
    _Tree,
)
from kubernetes_autoscaler_tpu_torch.ops.constrained import (
    BIG,
    GroupConstraints,
    place_lanes,
    zone_agg,
)
from kubernetes_autoscaler_tpu_torch.ops.pack import fit_count
from kubernetes_autoscaler_tpu_torch.ops.predicates import feasibility_mask
from kubernetes_autoscaler_tpu_torch.ops.schedule import resident_group_counts

# memory budget of one [C, N, R] int32 free-capacity plane of the first-fit
CHUNK_BYTES = 256 * 2 ** 20


def default_chunk(c_total: int, n: int, r: int) -> int:
    """Candidates per chunk: as many as keep one [C, N, R] int32 plane
    within CHUNK_BYTES, split evenly over the chunks that needs."""
    most = max(1, CHUNK_BYTES // (n * r * 4))
    n_chunks = max(1, -(-c_total // most))
    return max(1, -(-c_total // n_chunks))


# per-candidate drain failure reasons (the scale-down reason plane); codes
# and names are the reference package's
DRAIN_OK = 0
DRAIN_BLOCKED_BY_POD = 1       # a pod forbids draining (drainability rules)
DRAIN_NO_PLACE_FOR_GROUP = 2   # fail_group says WHICH pod shape found no room
DRAIN_TOO_MANY_SHAPES = 3      # > max_groups_per_node distinct shapes resident
DRAIN_REASON_NAMES = {
    DRAIN_OK: "",
    DRAIN_BLOCKED_BY_POD: "BlockedByPod",
    DRAIN_NO_PLACE_FOR_GROUP: "NoPlaceToMovePods",
    DRAIN_TOO_MANY_SHAPES: "TooManyPodShapes",
}


@dataclass(frozen=True)
class RemovalReasons(_Tree):
    """Explanation record per failed candidate (lazy second pass)."""

    reason: torch.Tensor      # i32[C] DRAIN_* code
    fail_group: torch.Tensor  # i32[C] first equivalence row with unplaced pods (-1)
    n_unplaced: torch.Tensor  # i32[C] movable pods with no destination


@dataclass(frozen=True)
class RemovalResult(_Tree):
    drainable: torch.Tensor    # bool[C] all movable pods re-placed & no blockers
    has_blocker: torch.Tensor  # bool[C] a pod forbids draining
    n_moved: torch.Tensor      # i32[C] pods that found a new home
    n_failed: torch.Tensor     # i32[C] movable pods with no destination
    dest_node: torch.Tensor    # i32[C, MPN] destination per pod slot (-1 = none)
    pod_slot: torch.Tensor     # i32[C, MPN] ScheduledPodTensors index per slot
    feas: torch.Tensor         # bool[G, N] shared predicate plane (pre-capacity)


def fetch_result(r: RemovalResult, phases=None) -> RemovalResult:
    """Device→host in at most three copies (ops/hostfetch); the bool `feas`
    plane rides bit-packed. `phases` turns on the byte counters."""
    from kubernetes_autoscaler_tpu_torch.ops.hostfetch import fetch_pytree

    return fetch_pytree(r, phases=phases)


def simulate_removals(
    nodes: NodeTensors,
    specs: PodGroupTensors,
    scheduled: ScheduledPodTensors,
    candidates: torch.Tensor,     # i32[C] node indices to try draining
    dest_allowed: torch.Tensor,   # bool[N] allowed destination nodes
    max_pods_per_node: int = 128,
    chunk: int | None = None,
    max_groups_per_node: int = 16,
    planes: AffinityPlanes | None = None,
    max_zones: int = 16,
    with_constraints: bool = False,
) -> RemovalResult:
    """Simulate removing every candidate node independently. `chunk`
    (candidates per chunk) defaults to `default_chunk`. `with_constraints`
    (with the resident `planes`) makes the re-placement topology-aware."""
    return _sweep(nodes, specs, scheduled, candidates, dest_allowed,
                  max_pods_per_node, chunk, max_groups_per_node,
                  explain=False,
                  planes=planes if with_constraints else None,
                  max_zones=max_zones)


def failure_reasons(
    nodes: NodeTensors,
    specs: PodGroupTensors,
    scheduled: ScheduledPodTensors,
    candidates: torch.Tensor,     # i32[C] FAILED candidate node indices
    dest_allowed: torch.Tensor,
    max_pods_per_node: int = 128,
    chunk: int | None = None,
    max_groups_per_node: int = 16,
) -> RemovalReasons:
    """The lazy drain reason pass: re-run the per-candidate group
    compaction + first-fit for the candidates the sweep reported
    undrainable, and say WHY — blocked-by-pod, no-place-for-pod-group-k,
    or shape overflow. Callers run it only when some candidate failed, and
    only over the failed subset. Explanatory, not a verdict:
    drainability truth stays with `simulate_removals`."""
    return _sweep(nodes, specs, scheduled, candidates, dest_allowed,
                  max_pods_per_node, chunk, max_groups_per_node,
                  explain=True)


def _sweep(nodes, specs, scheduled, candidates, dest_allowed,
           max_pods_per_node, chunk, max_groups_per_node, explain: bool,
           planes: AffinityPlanes | None = None, max_zones: int = 16):
    """The chunked sweep behind both entry points: RemovalResult, or with
    `explain` the RemovalReasons of the same first-fit. `planes` turns on
    the topology-aware re-placement."""
    n = nodes.n
    g_total = specs.g
    mpn = max_pods_per_node
    kk = max_groups_per_node
    dev = nodes.cap.device
    i32 = torch.int32

    # shared predicate plane, placement-independent
    feas_gn = feasibility_mask(nodes, specs, check_resources=False)
    resident = resident_group_counts(scheduled, g_total, n)
    feas_gn = feas_gn & ~(specs.anti_affinity_self[:, None] & (resident > 0))
    limit_g = specs.one_per_node()
    free0 = nodes.free()
    dest_ok = dest_allowed & nodes.valid & nodes.ready & nodes.schedulable
    node_ids = torch.arange(n, dtype=i32, device=dev)
    topo = _Topology(nodes, specs, planes, max_zones) if planes is not None \
        else None
    if topo is not None:
        feas_gn = feas_gn & topo.host_gate

    # resident pods sorted by node: each candidate's pods are one window
    sort_key = torch.where(scheduled.valid, scheduled.node_idx, n + 1)
    pod_order = torch.argsort(sort_key, stable=True).to(i32)
    sorted_nodes = sort_key[pod_order]
    starts = torch.searchsorted(sorted_nodes, node_ids).to(i32)
    pad_order = torch.cat([pod_order, torch.full((mpn,), -1, dtype=i32, device=dev)])
    window = torch.arange(mpn, dtype=torch.int64, device=dev)
    slot_k = torch.arange(kk, device=dev)
    group_ids = torch.arange(g_total, dtype=i32, device=dev)

    c_total = int(candidates.shape[0])
    chunk = chunk or default_chunk(c_total, n, free0.shape[1])
    pad_c = max(((c_total + chunk - 1) // chunk) * chunk, chunk)
    cand_pad = torch.cat([candidates.to(i32),
                          torch.zeros((pad_c - c_total,), dtype=i32, device=dev)])

    outs = []
    for c0 in range(0, pad_c, chunk):
        c = cand_pad[c0:c0 + chunk]                                   # [C]
        cn = c.shape[0]
        slots = pad_order[starts[c].long()[:, None] + window[None, :]]  # [C, MPN]
        safe = slots.clamp(min=0).long()
        on_c = ((slots >= 0) & (scheduled.node_idx[safe] == c[:, None])
                & scheduled.valid[safe])
        movable = on_c & scheduled.movable[safe]
        blocker = (on_c & scheduled.blocks[safe]).any(dim=1)

        # --- compact this node's movable pods into K group slots ---
        gref = torch.where(movable, scheduled.group_ref[safe], g_total)  # sentinel
        counts = torch.zeros((cn, g_total + 1), dtype=i32, device=dev)
        counts.scatter_add_(1, gref.long(), movable.to(i32))
        nz = counts[:, :g_total] > 0                                   # [C, G]
        rank = torch.cumsum(nz, dim=1) - 1
        compact_of_g = torch.where(nz & (rank < kk), rank, kk)          # [C, G]
        # only the sentinel slot kk can repeat in this scatter, and it is
        # sliced away, so the unspecified order of repeated writes is harmless
        gidx = torch.zeros((cn, kk + 1), dtype=i32, device=dev)
        gidx.scatter_(1, compact_of_g, group_ids.expand(cn, g_total))
        gidx = gidx[:, :kk].long()                                     # [C, K]
        filled = slot_k[None, :] < nz.sum(dim=1).clamp(max=kk)[:, None]
        cnt_k = torch.where(filled, torch.gather(counts[:, :g_total], 1, gidx), 0)

        dest = dest_ok[None, :] & (node_ids[None, :] != c[:, None])    # [C, N]
        if topo is not None:
            # the (candidate, slot) lanes with a wave loop to run, on the
            # device: place_lanes' `active`
            slow = (topo.is_con[gidx] & (cnt_k > 0)).T.contiguous()    # [K, C]

        # --- K-step first-fit of whole groups onto destinations ---
        free_c = free0.expand(cn, n, free0.shape[1])
        placed_k, cumplace_k = [], []
        for j in range(kk):
            gi = gidx[:, j]
            want = cnt_k[:, j]
            reqg = specs.req[gi]                                       # [C, R]
            feas_row = feas_gn[gi] & dest
            if topo is not None:
                feas_row = feas_row & topo.zone_gate(gi, c.long())
            fit = fit_count(free_c, reqg)                              # [C, N]
            fit = torch.where(feas_row, fit, 0)
            fit = torch.where(limit_g[gi][:, None], fit.clamp(max=1), fit)
            fit = torch.minimum(fit, want[:, None])
            cum = torch.cumsum(fit, dim=1)
            place = torch.minimum((want[:, None] - (cum - fit)).clamp(min=0), fit)
            place = place.to(i32)
            new_free = free_c - place[:, :, None] * reqg[:, None, :]
            if topo is not None:
                # the lanes whose group is constrained and has pods re-place
                # by waves, over the first fit's result in place
                place_lanes(free_c, feas_row, reqg, want.contiguous(),
                            limit_g[gi],
                            topo.lane_constraints(gi, c.long()), max_zones,
                            active=slow[j], out=(new_free, place))
            free_c = new_free
            placed_k.append(place.sum(dim=1))
            cumplace_k.append(torch.cumsum(place, dim=1))
        placed_k = torch.stack(placed_k, dim=1)                        # [C, K]
        if explain:
            outs.append(_explain(blocker, movable, nz, gidx, cnt_k, placed_k,
                                 kk))
            continue
        n_moved = placed_k.sum(dim=1).to(i32)
        n_failed = (movable.sum(dim=1) - n_moved).to(i32)
        drainable = ~blocker & (n_failed == 0)

        # --- per-pod destinations from the placement curves ---
        same = (gref[:, :, None] == gref[:, None, :]) \
            & movable[:, :, None] & movable[:, None, :]
        before = torch.tril(same, -1).sum(dim=2)                       # [C, MPN]
        j_of_slot = torch.gather(
            torch.cat([compact_of_g,
                       torch.full((cn, 1), kk, dtype=compact_of_g.dtype,
                                  device=dev)], dim=1),
            1, gref.long())
        dests = torch.full((cn, mpn), -1, dtype=i32, device=dev)
        for j in range(kk):
            d_j = torch.searchsorted(cumplace_k[j], before + 1).to(i32)
            hit = movable & (j_of_slot == j) & (before < placed_k[:, j][:, None])
            dests = torch.where(hit, d_j, dests)
        pod_slot = torch.where(on_c, safe.to(i32), -1)
        outs.append((drainable, blocker, n_moved, n_failed, dests, pod_slot))

    if explain:
        reason, fail_group, n_unplaced = (
            torch.cat(parts)[:c_total] for parts in zip(*outs))
        return RemovalReasons(reason=reason, fail_group=fail_group,
                              n_unplaced=n_unplaced)
    drainable, blocker, n_moved, n_failed, dests, pod_slot = (
        torch.cat(parts)[:c_total] for parts in zip(*outs))
    return RemovalResult(
        drainable=drainable,
        has_blocker=blocker,
        n_moved=n_moved,
        n_failed=n_failed,
        dest_node=dests,
        pod_slot=pod_slot,
        feas=feas_gn,
    )


class _Topology:
    """The constrained sweep's candidate-independent state: host-level gates
    and zone aggregates over the real nodes; `zone_gate` and
    `lane_constraints` adjust the zone counts per candidate (its residents
    leave its zone) for the group gathered on each lane."""

    def __init__(self, nodes: NodeTensors, specs: PodGroupTensors,
                 planes: AffinityPlanes, max_zones: int):
        from kubernetes_autoscaler_tpu_torch.ops.predicates import (
            selector_match,
        )

        self.specs, self.planes, self.max_zones = specs, planes, max_zones
        n = nodes.n
        self.zval = nodes.zone_id > 0
        self.zcl = nodes.zone_id.clamp(0, max_zones - 1)
        self.zones = torch.arange(max_zones, dtype=self.zcl.dtype,
                                  device=self.zcl.device)
        self.node_ids = torch.arange(n, dtype=torch.int32,
                                     device=self.zcl.device)
        zone_kinds = (specs.spread_kind == 2) | (specs.aff_kind == 2)
        self.host_gate = ((planes.anti_host_cnt == 0)
                          & torch.where(((specs.aff_kind == 1)
                                         & ~specs.aff_self)[:, None],
                                        planes.aff_cnt > 0, True)
                          & torch.where(zone_kinds[:, None],
                                        self.zval[None, :], True))
        self.anti_zone = zone_agg(planes.anti_zone_cnt, nodes.zone_id,
                                  max_zones)
        self.aff_zone = zone_agg(planes.aff_cnt, nodes.zone_id, max_zones)
        self.cnt_zone = zone_agg(planes.spread_cnt, nodes.zone_id, max_zones)
        elig_host = selector_match(nodes.label_hash, specs) \
            & nodes.valid[None, :]
        self.s_elig = torch.where((specs.spread_kind == 2)[:, None],
                                  elig_host & self.zval[None, :], elig_host)
        self.elig_zone = zone_agg(self.s_elig, nodes.zone_id, max_zones)
        self.is_con = ((specs.spread_kind > 0) | (specs.aff_kind > 0)
                       | specs.anti_self_zone)
        self.aff2 = (specs.aff_kind == 2) & ~specs.aff_self

    def _adjusted(self, agg: torch.Tensor, plane: torch.Tensor,
                  gi: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """i32[C, Z]: the zone totals `agg` of group gi[k], less what
        candidate c[k] holds in its own zone (`plane[gi, c]`)."""
        dz = ((self.zones[None, :] == self.zcl[c][:, None])
              & self.zval[c][:, None]).to(torch.int32)
        return agg[gi] - dz * plane[gi, c][:, None]

    def _at_nodes(self, per_zone: torch.Tensor) -> torch.Tensor:
        """[C, Z] → [C, N]: each node's zone's value."""
        return per_zone.gather(
            1, self.zcl.long()[None, :].expand(per_zone.shape[0], -1))

    def zone_gate(self, gi: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """bool[C, N]: the zone-level anti-affinity block and non-self zone
        affinity of group gi[k] with candidate c[k] drained."""
        anti = self._adjusted(self.anti_zone, self.planes.anti_zone_cnt, gi, c)
        aff = self._adjusted(self.aff_zone, self.planes.aff_cnt, gi, c)
        gate = ~(self.zval[None, :] & (self._at_nodes(anti) > 0))
        return gate & torch.where(self.aff2[gi][:, None],
                                  self.zval[None, :] & (self._at_nodes(aff) > 0),
                                  True)

    def lane_constraints(self, gi: torch.Tensor,
                         c: torch.Tensor) -> GroupConstraints:
        """The wave placer's constraints for group gi[k] re-placing the pods
        of candidate c[k], one lane each."""
        specs, planes = self.specs, self.planes
        aff = self._adjusted(self.aff_zone, planes.aff_cnt, gi, c)
        elig = self._adjusted(self.elig_zone, self.s_elig, gi, c) > 0
        return GroupConstraints(
            s_kind=specs.spread_kind[gi], s_skew=specs.max_skew[gi],
            s_self=specs.spread_self[gi],
            s_cnt_node=planes.spread_cnt[gi],
            s_elig=self.s_elig[gi] & (self.node_ids[None, :] != c[:, None]),
            a_kind=specs.aff_kind[gi], a_self=specs.aff_self[gi],
            a_any=specs.aff_match_any[gi],
            a_ok_node=torch.where(
                (specs.aff_kind[gi] == 1)[:, None], planes.aff_cnt[gi] > 0,
                self.zval[None, :] & (self._at_nodes(aff) > 0)),
            anti_self_zone=specs.anti_self_zone[gi],
            cnt_zone_base=self._adjusted(self.cnt_zone, planes.spread_cnt,
                                         gi, c),
            elig_zone_base=elig,
            min_host_base=torch.full(gi.shape, BIG,
                                     dtype=torch.int32, device=gi.device),
            zone_cl=self.zcl[None, :], zone_valid=self.zval[None, :])


def _explain(blocker, movable, nz, gidx, cnt_k, placed_k, kk):
    """One chunk's failure attribution: (reason, fail_group, n_unplaced),
    each i32[C]."""
    i32 = torch.int32
    unplaced_k = cnt_k - placed_k                                  # [C, K]
    scan_fail = (unplaced_k > 0).any(dim=1)
    # argmax of a bool row: the first True (0 when none, then unused)
    first_j = (unplaced_k > 0).to(i32).argmax(dim=1)
    fail_group = torch.where(
        scan_fail, torch.gather(gidx, 1, first_j[:, None].long())[:, 0], -1)
    n_unplaced = movable.sum(dim=1) - placed_k.sum(dim=1)
    overflow = nz.sum(dim=1) > kk
    reason = torch.where(
        blocker, DRAIN_BLOCKED_BY_POD,
        torch.where(scan_fail, DRAIN_NO_PLACE_FOR_GROUP,
                    torch.where(overflow, DRAIN_TOO_MANY_SHAPES, DRAIN_OK)))
    return reason.to(i32), fail_group.to(i32), n_unplaced.to(i32)

"""Batched node-removal (drain) simulation for scale-down.

Counterpart of the reference package's `ops/drain.py` (RemovalResult,
simulate_removals). Every candidate node is simulated independently:

  1. its resident movable pods are gathered from a by-node sorted window and
     compacted into at most K per-group counts,
  2. a K-step first-fit places each group's count onto the destination
     nodes in node order, each slot seeing what the candidate's earlier
     slots took,
  3. per-pod destinations are read from the groups' cumulative placements.

`sweep_inputs` is the placement-independent preparation: the predicate
plane with the resident self-anti-affinity term (row P,
ops/kernels/predicate_kernel.plane), the rest in plain torch; steps 1-3
are the drain kernel (ops/kernels/drain_kernel.sweep): on the card one
launch for every candidate (`csrc/drain.cu`), on the CPU its plain
version, in chunks of candidates.

With `with_constraints` the re-placement is topology-aware: host-level
gates join the predicate plane, the candidate's own residents leave its
zone's counts before its pods are re-placed (the reference's ghost node),
and constrained groups re-place by waves (the reference's
`place_group_constrained`). `topo_inputs` is its candidate-independent
preparation, in plain torch; the sweep is the same drain kernel
(`drain_kernel.sweep` with `topo`): on the card one launch, each
candidate's waves inside its CTA, reading nothing back to the host; on the
CPU its plain version, whose constrained slots re-place through the plain
wave placer (constrained_kernel.place_lanes_plain).

A node with more than `max_groups_per_node` distinct shapes is reported
undrainable (its overflow pods count in n_failed). The chunk size changes
the plain version's memory only, never results; by default it is worked
out from `drain_kernel.CHUNK_BYTES` and the world's N and R
(`default_chunk`).

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
from kubernetes_autoscaler_tpu_torch.ops.constrained import zone_agg
from kubernetes_autoscaler_tpu_torch.ops.kernels import drain_kernel
from kubernetes_autoscaler_tpu_torch.ops.kernels.drain_kernel import (
    DRAIN_BLOCKED_BY_POD,
    DRAIN_NO_PLACE_FOR_GROUP,
    DRAIN_OK,
    DRAIN_TOO_MANY_SHAPES,
    SweepInputs,
    TopoInputs,
    default_chunk,
)
from kubernetes_autoscaler_tpu_torch.ops.kernels import predicate_kernel

# the reference package's names of the per-candidate drain failure reasons
# (the scale-down reason plane); the codes are drain_kernel's
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


def sweep_inputs(nodes: NodeTensors, specs: PodGroupTensors,
                 scheduled: ScheduledPodTensors, candidates: torch.Tensor,
                 dest_allowed: torch.Tensor, max_pods_per_node: int,
                 host_gate: torch.Tensor | None = None) -> SweepInputs:
    """The placement-independent preparation of the sweep: the predicate
    plane with the resident self-anti-affinity term (one call of row P;
    then the topology's `host_gate`, bool[G, N]) and, in plain torch, the
    allowed destinations and the resident pods sorted by node so that each
    candidate's pods are one window of `pad_order`."""
    n = nodes.n
    mpn = max_pods_per_node
    dev = nodes.cap.device
    i32 = torch.int32

    feas_gn = predicate_kernel.plane(nodes, specs, predicate_kernel.STATIC,
                                     scheduled=scheduled)
    if host_gate is not None:
        feas_gn = feas_gn & host_gate
    dest_ok = dest_allowed & nodes.valid & nodes.ready & nodes.schedulable

    # resident pods sorted by node: each candidate's pods are one window
    sort_key = torch.where(scheduled.valid, scheduled.node_idx, n + 1)
    pod_order = torch.argsort(sort_key, stable=True).to(i32)
    sorted_nodes = sort_key[pod_order]
    starts = torch.searchsorted(sorted_nodes,
                                torch.arange(n, dtype=i32, device=dev)).to(i32)
    pad_order = torch.cat([pod_order, torch.full((mpn,), -1, dtype=i32, device=dev)])
    return SweepInputs(
        candidates=candidates.to(i32).contiguous(), starts=starts,
        pad_order=pad_order, node_idx=scheduled.node_idx.contiguous(),
        group_ref=scheduled.group_ref.contiguous(),
        valid=scheduled.valid.contiguous(),
        movable=scheduled.movable.contiguous(),
        blocks=scheduled.blocks.contiguous(), free=nodes.free().contiguous(),
        feas=feas_gn.contiguous(), dest_ok=dest_ok.contiguous(),
        limit_one=specs.one_per_node().contiguous(),
        req=specs.req.contiguous())


def topo_inputs(nodes: NodeTensors, specs: PodGroupTensors,
                planes: AffinityPlanes,
                max_zones: int) -> tuple[TopoInputs, torch.Tensor]:
    """The topology-aware sweep's candidate-independent preparation, in
    plain torch (the reference's drain.py:195-219): (TopoInputs, the host
    gates bool[G, N] that join the predicate plane)."""
    from kubernetes_autoscaler_tpu_torch.ops.predicates import selector_match

    zval = nodes.zone_id > 0
    zone_kinds = (specs.spread_kind == 2) | (specs.aff_kind == 2)
    host_aff = (specs.aff_kind == 1) & ~specs.aff_self
    host_gate = ((planes.anti_host_cnt == 0)
                 & torch.where(host_aff[:, None], planes.aff_cnt > 0, True)
                 & torch.where(zone_kinds[:, None], zval[None, :], True))
    elig_host = selector_match(nodes.label_hash, specs) & nodes.valid[None, :]
    s_elig = torch.where((specs.spread_kind == 2)[:, None],
                         elig_host & zval[None, :], elig_host)
    topo = TopoInputs(
        zone_cl=nodes.zone_id.clamp(0, max_zones - 1).to(torch.int32)
        .contiguous(),
        zone_valid=zval.contiguous(),
        s_kind=specs.spread_kind.contiguous(),
        s_skew=specs.max_skew.contiguous(),
        s_self=specs.spread_self.contiguous(),
        a_kind=specs.aff_kind.contiguous(),
        a_self=specs.aff_self.contiguous(),
        a_any=specs.aff_match_any.contiguous(),
        anti_self_zone=specs.anti_self_zone.contiguous(),
        spread_cnt=planes.spread_cnt.contiguous(),
        aff_cnt=planes.aff_cnt.contiguous(),
        anti_zone_cnt=planes.anti_zone_cnt.contiguous(),
        s_elig=s_elig.contiguous(),
        anti_zone=zone_agg(planes.anti_zone_cnt, nodes.zone_id, max_zones),
        aff_zone=zone_agg(planes.aff_cnt, nodes.zone_id, max_zones),
        cnt_zone=zone_agg(planes.spread_cnt, nodes.zone_id, max_zones),
        elig_zone=zone_agg(s_elig, nodes.zone_id, max_zones))
    return topo, host_gate


def _sweep(nodes, specs, scheduled, candidates, dest_allowed,
           max_pods_per_node, chunk, max_groups_per_node, explain: bool,
           planes: AffinityPlanes | None = None, max_zones: int = 16):
    """The sweep behind both entry points: RemovalResult, or with `explain`
    the RemovalReasons of the same first fit: the drain kernel's wrapper
    (`drain_kernel.sweep`: one launch on the card, the plain version on the
    CPU); `planes` turns on the topology-aware re-placement."""
    topo = host_gate = None
    if planes is not None:
        topo, host_gate = topo_inputs(nodes, specs, planes, max_zones)
    inp = sweep_inputs(nodes, specs, scheduled, candidates, dest_allowed,
                       max_pods_per_node, host_gate)
    out = drain_kernel.sweep(inp, max_groups_per_node, explain, chunk, topo)
    if explain:
        return RemovalReasons(*out)
    return RemovalResult(*out, feas=inp.feas)

"""The multiverse: the fused RunOnce body over a leading hypothesis axis B,
and time-compressed rollouts over T loops.

Counterpart of the reference package's `whatif/kernel.py`. Every lane runs
the port's own `ops/autoscale_step.run_once_fused` on its slice of the
lane-stacked inputs, and the lanes' outputs are stacked along axis 0. So
lane b is a serial `run_once_fused` on lane b's world by construction, and
the null-hypothesis lane (b = 0, the unperturbed branch world) gives the
live fused dispatch's decision planes bit for bit. Per-lane policy knobs
are tensors (limit_cap i32[B, NG], thresholds f32[B], per-lane prices in
the group tensors), never arguments that change the code path.

The fused body is not vectorised over lanes: the pack kernel is one launch
per call, so a multiverse step launches it twice per lane.

The rollout applies a *compressed actuation* after each step — placement is
the fused filter's exact arithmetic and the placed pods BIND (the carry is
the post-placement world, unlike the live loop where a real scheduler binds
asynchronously); scale-up materializes the winning option's template rows
into invalid node slots; scale-down retires empty drainable nodes below the
lane's utilization threshold — so the host sees only the compact per-step
decision trajectory (O(T·G)), never the worlds. Every actuation is a
`torch.where` over fixed shapes, so a world in equilibrium with its own
decisions (nothing placeable, nothing drainable) carries BITWISE unchanged:
the null-lane trajectory equals T live loops there.

No step reads the device from the host: the carry (nodes, specs) stays on
the device, the lanes' and steps' outputs are stacked there, and each entry
point returns host (numpy) trees fetched in ONE `ops/hostfetch.fetch_pytree`
round trip.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    Dims,
    NodeGroupTensors,
    NodeTensors,
    PodGroupTensors,
    ScheduledPodTensors,
    _Tree,
)
from kubernetes_autoscaler_tpu_torch.ops import hostfetch, scoring
from kubernetes_autoscaler_tpu_torch.ops.autoscale_step import (  # noqa: F401 — variants.py takes _map from here
    FusedDecision,
    _lane,
    _map,
    _stack,
    run_once_fused,
)

i32 = torch.int32
f32 = torch.float32


@dataclass(frozen=True)
class LaneSummary(_Tree):
    """Per-lane scalars reduced on the device, so the multiverse fetch stays
    O(B) + the decision planes — cost / utilization / disruption are the
    deltas the what-if consumer ranks lanes by (report.py subtracts the
    null lane on host)."""

    scaleup_cost: torch.Tensor   # f32 price of the winning expansion option
    fleet_price: torch.Tensor    # f32 Σ price_per_node over live grouped nodes
    utilization: torch.Tensor    # f32 mean post-placement util over valid nodes
    disruption: torch.Tensor     # i32 drainable (evictable) node count
    pending: torch.Tensor        # i32 pods still pending after the filter pass
    nodes_added: torch.Tensor    # i32 node count of the winning option
    best: torch.Tensor           # i32 winning node-group index (-1 = none)


@dataclass(frozen=True)
class RolloutStep(_Tree):
    """One step of the host-visible decision trajectory — the ONLY thing a
    rollout fetches (the worlds stay on the device)."""

    verdict: torch.Tensor        # i32[G] filter placements (live-loop surface)
    pending_after: torch.Tensor  # i32[G] pods pending after the filter
    best: torch.Tensor           # i32 winning node-group index (-1 = none)
    nodes_added: torch.Tensor    # i32 nodes materialized this step
    nodes_removed: torch.Tensor  # i32 empty drainable nodes retired this step
    util_mean: torch.Tensor      # f32 mean utilization over valid nodes
    scaleup_cost: torch.Tensor   # f32 price of this step's expansion
    fleet_price: torch.Tensor    # f32 post-actuation fleet price rate


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along axis 0 for a 0-d device index, without reading it on
    the host (a tensor index of rank 0 would be read with `.item()`)."""
    return x.index_select(0, idx.reshape(1)).squeeze(0)


def _fleet_price(nodes: NodeTensors, price: torch.Tensor) -> torch.Tensor:
    gid = torch.clamp(nodes.group_id, min=0)
    return torch.where(nodes.valid & (nodes.group_id >= 0),
                       price.index_select(0, gid), 0.0).sum()


def _util_mean(util: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    nvalid = valid.sum()
    return torch.where(nvalid > 0,
                       (util * valid).sum() / torch.clamp(nvalid, min=1), 0.0)


def _choice(dec: FusedDecision, groups: NodeGroupTensors, strategy: str):
    """(best, clamped index, nodes the option adds, its price)."""
    best = scoring.best_option(dec.scores, strategy)
    b = torch.clamp(best, min=0)
    n_add = torch.where(best >= 0, _at(dec.est_node_count, b), 0)
    cost = torch.where(best >= 0,
                       _at(groups.price_per_node, b) * n_add.to(f32), 0.0)
    return best, b, n_add, cost


def _summarize(dec: FusedDecision, nodes: NodeTensors,
               groups: NodeGroupTensors, strategy: str) -> LaneSummary:
    best, _b, n_add, cost = _choice(dec, groups, strategy)
    disruption = (dec.drainable & ~dec.has_blocker & nodes.valid).sum()
    return LaneSummary(
        scaleup_cost=cost,
        fleet_price=_fleet_price(nodes, groups.price_per_node),
        utilization=_util_mean(dec.util, nodes.valid),
        disruption=disruption.to(i32),
        pending=dec.pending_after.sum().to(i32),
        nodes_added=n_add.to(i32),
        best=best,
    )


def multiverse_step(
    nodes: NodeTensors,              # leading axis B on every tensor input
    specs: PodGroupTensors,
    scheduled: ScheduledPodTensors,
    groups: NodeGroupTensors,
    limit_cap: torch.Tensor,         # i32[B, NG] per-lane composed cap
    dims: Dims,
    max_new_nodes: int = 256,
    max_pods_per_node: int = 128,
    strategy: str = "least-waste",
) -> tuple[FusedDecision, LaneSummary]:
    """One fused RunOnce step over B hypothesis lanes.

    Returns the FULL batched decision planes (verdict / options / drain —
    every leaf gains axis 0 of size B) plus the on-device LaneSummary
    reduction, as host numpy trees fetched together in one round trip.
    Lane b is bit-identical to a serial `run_once_fused` call on lane b's
    world.

    The per-lane body is the unconstrained path (planes=None): worlds with
    constraint overlays take the serial fused dispatch instead. The drain
    sweep sizes its own candidate chunks (`ops/drain.default_chunk`)."""
    decs, sums = [], []
    for b in range(limit_cap.shape[0]):
        gt = _lane(groups, b)
        dec, res = run_once_fused(
            _lane(nodes, b), _lane(specs, b), _lane(scheduled, b), gt,
            limit_cap[b], dims, max_new_nodes, max_pods_per_node)
        decs.append(dec)
        sums.append(_summarize(dec, res.nodes, gt, strategy))
    return hostfetch.fetch_pytree((_stack(decs), _stack(sums)))


def _actuate(nodes2: NodeTensors, dec: FusedDecision, tmpl: NodeTensors,
             groups: NodeGroupTensors, threshold: torch.Tensor,
             strategy: str):
    """Compressed actuation on the post-placement resident nodes: graft the
    winning option's template rows into invalid slots, retire empty
    drainable nodes under the lane threshold. Every branch is a
    `torch.where` over fixed shapes — a no-op decision (best == -1, nothing
    drainable) leaves the planes BITWISE unchanged, which is what keeps the
    null lane's steady-state trajectory byte-identical to the live loop."""
    best, b, n_add, cost = _choice(dec, groups, strategy)
    inv = ~nodes2.valid
    rank = torch.cumsum(inv.to(i32), 0, dtype=i32) * inv.to(i32)
    take = inv & (rank > 0) & (rank <= n_add)

    def graft(cur, rows):
        row = _at(rows, b)
        mask = take.reshape(take.shape + (1,) * (cur.ndim - 1))
        return torch.where(mask, row, cur)

    nodes3 = NodeTensors(
        cap=graft(nodes2.cap, tmpl.cap),
        alloc=graft(nodes2.alloc, tmpl.alloc),
        label_hash=graft(nodes2.label_hash, tmpl.label_hash),
        taint_exact=graft(nodes2.taint_exact, tmpl.taint_exact),
        taint_key=graft(nodes2.taint_key, tmpl.taint_key),
        used_ports=graft(nodes2.used_ports, tmpl.used_ports),
        zone_id=graft(nodes2.zone_id, tmpl.zone_id),
        group_id=torch.where(take, b.to(i32), nodes2.group_id),
        ready=nodes2.ready | take,
        schedulable=nodes2.schedulable | take,
        valid=nodes2.valid | take,
    )
    # retire: drainable, unblocked, below the lane threshold AND empty —
    # the compressed policy never migrates residents, so only pod-free
    # nodes leave the world (the drain verdicts of freshly-grafted rows
    # are last step's sweep of an invalid slot: exclude them)
    empty = nodes3.alloc.sum(dim=1) == 0
    remove = (nodes3.valid & dec.drainable & ~dec.has_blocker
              & (dec.util < threshold) & empty & ~take)
    nodes4 = nodes3.replace(
        ready=nodes3.ready & ~remove,
        schedulable=nodes3.schedulable & ~remove,
        valid=nodes3.valid & ~remove,
    )
    fleet = _fleet_price(nodes4, groups.price_per_node)
    return nodes4, best, take.sum(), remove.sum(), cost, fleet


def _rollout_lane(nodes, specs, scheduled, groups, limit_cap, threshold,
                  adds, fails, dims, max_new_nodes, max_pods_per_node,
                  strategy) -> RolloutStep:
    """T fused steps with their actuation, carried on the device; the steps
    stacked on axis 0 (device tensors, nothing fetched)."""
    tmpl = groups.as_node_tensors(dims)
    nodes_c, specs_c = nodes, specs
    steps = []
    for t in range(adds.shape[0]):
        # workload injection for this simulated loop: pending-pod arrivals
        # (negative = completions) and spot reclaims / failures
        specs_c = specs_c.replace(
            count=torch.clamp(specs_c.count + adds[t], min=0))
        nodes_c = nodes_c.replace(
            ready=nodes_c.ready & ~fails[t],
            schedulable=nodes_c.schedulable & ~fails[t])
        dec, res = run_once_fused(
            nodes_c, specs_c, scheduled, groups, limit_cap, dims,
            max_new_nodes, max_pods_per_node)
        nodes4, best, added, removed, cost, fleet = _actuate(
            res.nodes, dec, tmpl, groups, threshold, strategy)
        steps.append(RolloutStep(
            verdict=dec.verdict,
            pending_after=dec.pending_after,
            best=best,
            nodes_added=added.to(i32),
            nodes_removed=removed.to(i32),
            util_mean=_util_mean(dec.util, res.nodes.valid),
            scaleup_cost=cost,
            fleet_price=fleet,
        ))
        nodes_c, specs_c = nodes4, res.specs
    return _stack(steps)


def _on(x, dtype, device) -> torch.Tensor:
    """A workload or knob argument (numpy, a number or a tensor) as a
    tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def rollout_fused(
    nodes: NodeTensors,
    specs: PodGroupTensors,
    scheduled: ScheduledPodTensors,
    groups: NodeGroupTensors,
    limit_cap: torch.Tensor,  # i32[NG]
    threshold,                # f32 scale-down utilization threshold
    adds,                     # i32[T, G] pending-pod arrivals per step
    fails,                    # bool[T, N] node failures / spot reclaims
    dims: Dims,
    max_new_nodes: int = 256,
    max_pods_per_node: int = 128,
    strategy: str = "least-waste",
) -> RolloutStep:
    """T fused loops with the compressed actuation between them, and one
    compact trajectory fetch instead of T round trips. The carry is (nodes,
    specs); `scheduled` (resident pods) stays the branch world's — the
    compressed policy moves capacity, not residents. Returns the host
    (numpy) trajectory, every leaf with a leading T axis."""
    dev = nodes.cap.device
    traj = _rollout_lane(
        nodes, specs, scheduled, groups, limit_cap,
        _on(threshold, np.float32, dev), _on(adds, np.int32, dev),
        _on(fails, np.bool_, dev), dims, max_new_nodes, max_pods_per_node,
        strategy)
    return hostfetch.fetch_pytree(traj)


def rollout_multiverse(
    nodes: NodeTensors,       # leading axis B on every tensor input
    specs: PodGroupTensors,
    scheduled: ScheduledPodTensors,
    groups: NodeGroupTensors,
    limit_cap: torch.Tensor,  # i32[B, NG]
    thresholds,               # f32[B]
    adds,                     # i32[B, T, G]
    fails,                    # bool[B, T, N]
    dims: Dims,
    max_new_nodes: int = 256,
    max_pods_per_node: int = 128,
    strategy: str = "least-waste",
) -> RolloutStep:
    """B lanes × T loops with one trajectory fetch. Every RolloutStep leaf
    gains a leading lane axis; lane b is bit-identical to `rollout_fused`
    on lane b's world and workload."""
    dev = nodes.cap.device
    thresholds = _on(thresholds, np.float32, dev)
    adds = _on(adds, np.int32, dev)
    fails = _on(fails, np.bool_, dev)
    trajs = [
        _rollout_lane(_lane(nodes, b), _lane(specs, b), _lane(scheduled, b),
                      _lane(groups, b), limit_cap[b], thresholds[b], adds[b],
                      fails[b], dims, max_new_nodes, max_pods_per_node,
                      strategy)
        for b in range(limit_cap.shape[0])]
    return hostfetch.fetch_pytree(_stack(trajs))

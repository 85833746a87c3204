"""The autoscaling simulation steps: one control loop's device content.

Counterpart of the reference package's `ops/autoscale_step.py` on one
device (no `mesh`). `with_constraints`, with the resident `planes`, routes
the filter pack, every option pack and the drain sweep through the
topology-coupled wave placer (ops/constrained.py), as in the reference.

The phased path — `scale_up_sim` (filter pack, with an optional wavefront
plan, then every option's estimate and the expander's choice),
`scale_down_sim` (eligibility and the drain sweep over every node) and
`run_once_sim` (both on one snapshot) — is the live loop's oracle and the
reference bench's scale-up measurement.

`run_once_fused` (the live default) runs three phases on the
post-placement world, in order:

  filter      predicates + FFD pack of the pending groups onto the existing
              nodes (kernel launch 1; with constraints the constrained
              pack), placements charged to the nodes;
  scale-up    every node group's option packed into empty template bins
              (kernel launch 2; with constraints the constrained pack),
              then the expander scores;
  scale-down  utilization and the drain sweep over every node.

Every output keeps the reference's dtype (i32, bool or f32). The tensors'
device decides where it runs: CUDA tensors run the pack kernel, CPU tensors
its plain version. The constrained pack is plain torch on both.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    AffinityPlanes,
    ClusterTensors,
    Dims,
    NodeGroupTensors,
    NodeTensors,
    PodGroupTensors,
    ScheduledPodTensors,
    _Tree,
)
from kubernetes_autoscaler_tpu_torch.ops import drain, schedule, scoring, utilization
from kubernetes_autoscaler_tpu_torch.ops.binpack import EstimateResult, estimate_all
from kubernetes_autoscaler_tpu_torch.ops.pack import WavefrontPlan
from kubernetes_autoscaler_tpu_torch.ops.scoring import OptionScores

PHASES = ("filter", "scale_up", "scale_down")


@dataclass(frozen=True)
class ScaleUpSim(_Tree):
    fits_existing: torch.Tensor  # i32[G] pending pods absorbed by current capacity
    remaining: torch.Tensor      # i32[G] pods that need new nodes
    estimate: EstimateResult     # per-node-group expansion options
    scores: OptionScores
    best: torch.Tensor           # i32 winning node group index (-1 = none)


@dataclass(frozen=True)
class ScaleDownSim(_Tree):
    eligible: torch.Tensor        # bool[N] below the utilization threshold
    removal: drain.RemovalResult  # per-candidate drain verdicts (C == N)
    utilization: torch.Tensor     # f32[N]


def scale_up_sim(
    nodes: NodeTensors,
    specs: PodGroupTensors,
    scheduled: ScheduledPodTensors,
    groups: NodeGroupTensors,
    dims: Dims,
    max_new_nodes: int = 256,
    strategy: str = "least-waste",
    planes: AffinityPlanes | None = None,
    with_constraints: bool = False,
    wavefront_plan: WavefrontPlan | None = None,
) -> ScaleUpSim:
    """The filter pack onto the existing nodes, then every node group's
    expansion option for what is left, the expander scores and the chosen
    option. A worthwhile `wavefront_plan` (schedule.plan_wavefronts) takes
    the filter pack through the wavefront pack; the results are the same.
    `with_constraints` (with `planes`) takes both packs through the
    constrained pack, ahead of any plan."""
    packed = schedule.schedule_pending_on_existing(
        nodes, specs, scheduled, planes=planes, max_zones=dims.max_zones,
        with_constraints=with_constraints, wavefront_plan=wavefront_plan)
    remaining = torch.clamp(specs.count - packed.scheduled, min=0)
    est = estimate_all(specs.replace(count=remaining), groups, dims,
                       max_new_nodes, planes=planes, nodes=nodes,
                       with_constraints=with_constraints)
    sc = scoring.score_options(est, groups)
    return ScaleUpSim(fits_existing=packed.scheduled, remaining=remaining,
                      estimate=est, scores=sc,
                      best=scoring.best_option(sc, strategy))


def scale_down_sim(
    nodes: NodeTensors,
    specs: PodGroupTensors,
    scheduled: ScheduledPodTensors,
    threshold: float = 0.5,
    max_pods_per_node: int = 128,
    planes: AffinityPlanes | None = None,
    max_zones: int = 16,
    with_constraints: bool = False,
) -> ScaleDownSim:
    """Eligibility and the drain sweep with every node as a candidate and
    every node but the candidate as a destination (verdicts are per
    candidate in isolation). The sweep sizes its candidate chunks itself
    (`drain.default_chunk`); chunks never change results.
    `with_constraints` (with `planes`) makes the re-placement
    topology-aware."""
    dev = nodes.cap.device
    removal = drain.simulate_removals(
        nodes, specs, scheduled,
        torch.arange(nodes.n, dtype=torch.int32, device=dev),
        dest_allowed=torch.ones((nodes.n,), dtype=torch.bool, device=dev),
        max_pods_per_node=max_pods_per_node, planes=planes,
        max_zones=max_zones, with_constraints=with_constraints)
    return ScaleDownSim(
        eligible=utilization.eligible_for_scale_down(nodes, threshold),
        removal=removal, utilization=utilization.node_utilization(nodes))


def run_once_sim(
    cluster: ClusterTensors,
    dims: Dims,
    max_new_nodes: int = 256,
    strategy: str = "least-waste",
    threshold: float = 0.5,
    max_pods_per_node: int = 128,
    with_constraints: bool = False,
) -> tuple[ScaleUpSim, ScaleDownSim]:
    """A whole RunOnce's simulation content on one snapshot: scale-up and
    scale-down both on the pre-placement world; `with_constraints` uses
    the snapshot's `planes`."""
    planes = cluster.planes if with_constraints else None
    up = scale_up_sim(cluster.nodes, cluster.pending, cluster.scheduled,
                      cluster.groups, dims, max_new_nodes, strategy,
                      planes=planes, with_constraints=with_constraints)
    down = scale_down_sim(cluster.nodes, cluster.pending, cluster.scheduled,
                          threshold, max_pods_per_node, planes=planes,
                          max_zones=dims.max_zones,
                          with_constraints=with_constraints)
    return up, down


@dataclass(frozen=True)
class FusedDecision(_Tree):
    """Compact decision tensors of one step, O(G + NG + N): what the host
    control plane consumes."""

    verdict: torch.Tensor         # i32[G] pods of each group placed on existing nodes
    pending_after: torch.Tensor   # i32[G] pods still pending after the filter
    est_node_count: torch.Tensor  # i32[NG] nodes each expansion option adds
    est_scheduled: torch.Tensor   # i32[NG, G] pods each option schedules
    scores: OptionScores          # expander inputs incl. helped_req f32[NG, R]
    util: torch.Tensor            # f32[N] post-placement node utilization
    drainable: torch.Tensor       # bool[N] scale-down candidate verdicts
    has_blocker: torch.Tensor     # bool[N] drain refused by a blocking pod
    alloc_after: torch.Tensor     # i32[N, R] post-placement allocations


@dataclass(frozen=True)
class FusedResident(_Tree):
    """Outputs that stay on the device: the post-placement world, the full
    drain sweep and the verdict plane."""

    nodes: NodeTensors
    specs: PodGroupTensors
    removal: drain.RemovalResult  # C == N (all-nodes sweep)
    verdict: torch.Tensor         # i32[G]


def run_once_fused(
    nodes: NodeTensors,
    specs: PodGroupTensors,
    scheduled: ScheduledPodTensors,
    groups: NodeGroupTensors,
    limit_cap: torch.Tensor,     # i32[NG] host-composed scale-up limiter cap
    dims: Dims,
    max_new_nodes: int = 256,
    max_pods_per_node: int = 128,
    planes: AffinityPlanes | None = None,
    with_constraints: bool = False,
    on_phase=None,
) -> tuple[FusedDecision, FusedResident]:
    """The whole control-loop device content as one call. The drain sweep
    sizes its candidate chunks itself (`drain.default_chunk`).
    `with_constraints` (with the resident `planes`) takes the filter pack,
    the option packs and the drain sweep through the constrained tier.

    `on_phase`, if given, is called with each name of PHASES as that phase
    begins and with "end" after the last one (callers place CUDA events
    there to time the phases)."""
    mark = on_phase or (lambda name: None)
    i32 = torch.int32

    mark("filter")
    packed = schedule.schedule_pending_on_existing(
        nodes, specs, scheduled, planes=planes, max_zones=dims.max_zones,
        with_constraints=with_constraints)
    # the placement charge sum_g placed[g, n] * req[g, r]: an int32 product
    # has no CUDA matmul, so broadcast, sum in int64 and narrow (wrapping as
    # the reference's int32 einsum does)
    add = (packed.placed[:, :, None].to(torch.int64)
           * specs.req[:, None, :].to(torch.int64)).sum(dim=0).to(i32)
    nodes2 = nodes.replace(alloc=nodes.alloc + add)
    specs2 = specs.replace(count=torch.clamp(
        specs.count - packed.placed.sum(dim=1), min=0).to(i32))

    mark("scale_up")
    capped = groups.replace(max_new=torch.minimum(groups.max_new, limit_cap))
    est = estimate_all(specs2, capped, dims, max_new_nodes, planes=planes,
                       nodes=nodes2, with_constraints=with_constraints)
    # scores on the UNCAPPED group tensors + post-placement specs
    sc = scoring.score_options(est, groups, specs=specs2)

    mark("scale_down")
    util = utilization.node_utilization(nodes2)
    dev = nodes.cap.device
    removal = drain.simulate_removals(
        nodes2, specs2, scheduled,
        torch.arange(nodes.n, dtype=i32, device=dev),
        dest_allowed=torch.ones((nodes.n,), dtype=torch.bool, device=dev),
        max_pods_per_node=max_pods_per_node, planes=planes,
        max_zones=dims.max_zones, with_constraints=with_constraints)
    mark("end")

    decision = FusedDecision(
        verdict=packed.scheduled,
        pending_after=specs2.count,
        est_node_count=est.node_count,
        est_scheduled=est.scheduled,
        scores=sc,
        util=util,
        drainable=removal.drainable,
        has_blocker=removal.has_blocker,
        alloc_after=nodes2.alloc,
    )
    resident = FusedResident(nodes=nodes2, specs=specs2, removal=removal,
                             verdict=packed.scheduled)
    return decision, resident

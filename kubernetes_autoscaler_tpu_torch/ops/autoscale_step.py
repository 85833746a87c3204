"""The fused autoscaling simulation step: one control loop's device content.

Counterpart of the reference package's `ops/autoscale_step.run_once_fused`
(with `planes=None`, `with_constraints=False`: the live default). Three
phases on the post-placement world, in order:

  filter      predicates + FFD pack of the pending groups onto the existing
              nodes (kernel launch 1), placements charged to the nodes;
  scale-up    every node group's option packed into empty template bins
              (kernel launch 2), then the expander scores;
  scale-down  utilization and the drain sweep over every node.

Every output keeps the reference's dtype (i32, bool or f32). The tensors'
device decides where it runs: CUDA tensors run the pack kernel, CPU tensors
its plain version.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    Dims,
    NodeGroupTensors,
    NodeTensors,
    PodGroupTensors,
    ScheduledPodTensors,
    _Tree,
)
from kubernetes_autoscaler_tpu_torch.ops import drain, schedule, scoring, utilization
from kubernetes_autoscaler_tpu_torch.ops.binpack import estimate_all
from kubernetes_autoscaler_tpu_torch.ops.scoring import OptionScores

PHASES = ("filter", "scale_up", "scale_down")


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
    on_phase=None,
) -> tuple[FusedDecision, FusedResident]:
    """The whole control-loop device content as one call. The drain sweep
    sizes its candidate chunks itself (`drain.default_chunk`).

    `on_phase`, if given, is called with each name of PHASES as that phase
    begins and with "end" after the last one (callers place CUDA events
    there to time the phases)."""
    mark = on_phase or (lambda name: None)
    i32 = torch.int32

    mark("filter")
    packed = schedule.schedule_pending_on_existing(nodes, specs, scheduled)
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
    est = estimate_all(specs2, capped, dims, max_new_nodes)
    # scores on the UNCAPPED group tensors + post-placement specs
    sc = scoring.score_options(est, groups, specs=specs2)

    mark("scale_down")
    util = utilization.node_utilization(nodes2)
    dev = nodes.cap.device
    removal = drain.simulate_removals(
        nodes2, specs2, scheduled,
        torch.arange(nodes.n, dtype=i32, device=dev),
        dest_allowed=torch.ones((nodes.n,), dtype=torch.bool, device=dev),
        max_pods_per_node=max_pods_per_node)
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

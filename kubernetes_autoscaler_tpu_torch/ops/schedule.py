"""Scheduling pending pods onto the existing cluster (filter-out-schedulable).

Counterpart of the reference package's `ops/schedule.py` for one device: a
predicate plane over every (pending group, node) pair, then one FFD pack of
all groups onto the current free capacity — the serial pack (K1), with a
worthwhile wavefront plan the wavefront pack (K2), or with topology-coupled
constraints the constrained pack (ops/constrained.py). `plan_wavefronts`
builds the wavefront plan on the host from the placement-independent mask.
"""

from __future__ import annotations

import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    AffinityPlanes,
    NodeTensors,
    PodGroupTensors,
    ScheduledPodTensors,
)
from kubernetes_autoscaler_tpu_torch.ops import predicates
from kubernetes_autoscaler_tpu_torch.ops.pack import (
    PackResult,
    WavefrontCache,
    WavefrontPlan,
    ffd_order,
    pack_groups,
    pack_groups_wavefront,
)


def resident_group_counts(scheduled: ScheduledPodTensors, g: int,
                          n: int) -> torch.Tensor:
    """i32[G, N]: resident pods of each equivalence group on each node
    (feeds self-anti-affinity masking)."""
    ok = scheduled.valid & (scheduled.node_idx >= 0)
    gr = torch.where(ok, scheduled.group_ref, 0).long()
    ni = torch.where(ok, scheduled.node_idx, 0).long()
    out = torch.zeros((g, n), dtype=torch.int32, device=ok.device)
    return out.index_put_((gr, ni), ok.to(torch.int32), accumulate=True)


def filter_pack_inputs(nodes: NodeTensors, specs: PodGroupTensors,
                       scheduled: ScheduledPodTensors | None = None):
    """The arguments `schedule_pending_on_existing` hands the pack:
    (free, mask, req, count, order, limit_one)."""
    mask = predicates.feasibility_mask(nodes, specs, check_resources=False)
    if scheduled is not None:
        resident = resident_group_counts(scheduled, specs.g, nodes.n)
        mask = mask & ~(specs.anti_affinity_self[:, None] & (resident > 0))
    order = ffd_order(specs.req, specs.valid & (specs.count > 0))
    count = torch.where(specs.valid, specs.count, 0)
    return (nodes.free(), mask, specs.req, count, order,
            specs.one_per_node())


def schedule_pending_on_existing(
    nodes: NodeTensors,
    specs: PodGroupTensors,
    scheduled: ScheduledPodTensors | None = None,
    planes: AffinityPlanes | None = None,
    max_zones: int = 16,
    with_constraints: bool = False,
    wavefront_plan: WavefrontPlan | None = None,
) -> PackResult:
    """First-fit all pending groups onto current free capacity; `scheduled`
    of the result says how many pods of each group fit the existing cluster.

    `with_constraints` (with the resident `planes`) selects the
    topology-coupled pack (ops/constrained.py), ahead of any plan. A
    worthwhile `wavefront_plan` (see plan_wavefronts) batches the group
    scan to depth W; otherwise the serial pack runs. The plan mask is a
    superset of the runtime mask here (it omits the resident
    self-anti-affinity subtraction), which pack_groups_wavefront allows."""
    free, mask, req, count, order, limit_one = filter_pack_inputs(
        nodes, specs, scheduled)
    if with_constraints and planes is not None:
        from kubernetes_autoscaler_tpu_torch.ops import constrained

        mask = mask & constrained.planes_static_mask(
            specs, planes, nodes.zone_id, max_zones)
        cons = constrained.constraints_for_nodes(specs, planes, nodes,
                                                 max_zones)
        return constrained.pack_groups_constrained(
            free, mask, req, count, order, limit_one, cons, max_zones)
    if wavefront_plan is not None and wavefront_plan.worthwhile:
        return pack_groups_wavefront(free, mask, req, count, limit_one,
                                     wavefront_plan)
    return pack_groups(free, mask, req, count, order, limit_one)


def plan_wavefronts(nodes: NodeTensors, specs: PodGroupTensors,
                    cache: WavefrontCache, phases=None) -> WavefrontPlan:
    """Host-side wavefront planning for the existing-nodes pack.

    Evaluates the placement-independent feasibility mask on the device,
    fetches it bit-packed through ops/hostfetch.fetch_pytree (counted under
    `batched_fetch_bytes_moved`/`_logical` on `phases`), and asks `cache`
    for a coloring; the plan's waves go to the nodes' device.

    The plan skips the resident self-anti-affinity subtraction, so its mask
    is a superset of every runtime mask and resident churn cannot
    invalidate it. Every count-dependence is kept out of the fingerprint
    too: `active` is `valid` alone and the layering order is
    `ffd_order(req, valid)`, not the runtime's `ffd_order(req, valid &
    count>0)`. The two differ only in where count-0 groups sit, and those
    place nothing wherever they sit, while the count>0 groups keep their
    relative order under the stable sort; so count churn is always a hit."""
    from kubernetes_autoscaler_tpu_torch.ops.hostfetch import fetch_pytree

    mask = predicates.feasibility_mask(nodes, specs, check_resources=False)
    order = ffd_order(specs.req, specs.valid)
    mask_h, order_h, active_h = fetch_pytree((mask, order, specs.valid),
                                             phases=phases)
    return cache.plan(mask_h, order_h, active=active_h, phases=phases,
                      device=nodes.cap.device)

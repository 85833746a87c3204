"""Scheduling pending pods onto the existing cluster (filter-out-schedulable).

Counterpart of the reference package's `ops/schedule.py` for the
unconstrained, unsharded, serial path (no wavefront plan): a predicate
plane over every (pending group, node) pair, then one FFD pack of all
groups onto the current free capacity.
"""

from __future__ import annotations

import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    NodeTensors,
    PodGroupTensors,
    ScheduledPodTensors,
)
from kubernetes_autoscaler_tpu_torch.ops import predicates
from kubernetes_autoscaler_tpu_torch.ops.pack import (
    PackResult,
    ffd_order,
    pack_groups,
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
) -> PackResult:
    """First-fit all pending groups onto current free capacity; `scheduled`
    of the result says how many pods of each group fit the existing cluster."""
    return pack_groups(*filter_pack_inputs(nodes, specs, scheduled))

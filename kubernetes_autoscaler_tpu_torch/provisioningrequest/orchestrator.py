"""ProvisioningRequest orchestration: check-capacity and best-effort-atomic.

Reference counterpart: provisioningrequest/orchestrator/ — the
WrapperOrchestrator (wrapper_orchestrator.go) alternates loops between
ProvisioningRequest handling and regular pending pods; checkcapacity/ runs a
booking simulation only (no cloud calls); besteffortatomic/ uses
NodeGroup.AtomicIncreaseSize for all-or-nothing scale-up
(cloud_provider.go:198-204).

TPU re-design: check-capacity is a pure device query — encode the request's
pods against the current node tensors and run the batched pack kernel; a
request fits iff every pod places. Best-effort-atomic reuses the batched
all-groups binpacking estimate and requires some group to absorb the WHOLE
request within its remaining headroom.
"""

from __future__ import annotations

import time

import numpy as np

from kubernetes_autoscaler_tpu_torch.cloudprovider.provider import (
    CloudProvider,
    NodeGroupError,
)
from kubernetes_autoscaler_tpu_torch.estimator.estimator import BinpackingEstimator
from kubernetes_autoscaler_tpu_torch.models.api import Node, Pod
from kubernetes_autoscaler_tpu_torch.models.cluster_state import DEFAULT_DIMS
from kubernetes_autoscaler_tpu_torch.models.encode import (
    encode_cluster,
    encode_node_groups,
)
from kubernetes_autoscaler_tpu_torch.ops.hostfetch import to_host
from kubernetes_autoscaler_tpu_torch.ops.schedule import schedule_pending_on_existing
from kubernetes_autoscaler_tpu_torch.provisioningrequest.api import (
    ACCEPTED,
    BEST_EFFORT_ATOMIC_CLASS,
    CHECK_CAPACITY_CLASS,
    FAILED,
    PROVISIONED,
    SUPPORTED_CLASSES,
    ProvisioningRequest,
)


class ProvReqOrchestrator:
    """Processes all actionable ProvisioningRequests in one pass."""

    def __init__(self, provider: CloudProvider, dims=DEFAULT_DIMS,
                 node_bucket: int = 64, group_bucket: int = 64,
                 max_new_nodes_static: int = 256, device=None):
        from kubernetes_autoscaler_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.provider = provider
        self.dims = dims
        self.node_bucket = node_bucket
        self.group_bucket = group_bucket
        self.max_new_nodes_static = max_new_nodes_static

    def run(self, provreqs: list[ProvisioningRequest], nodes: list[Node],
            scheduled_pods: list[Pod], now: float | None = None) -> list[str]:
        """Handle every pending supported request; returns names acted on.
        Expired bookings are flipped first (reference: provreq processors)."""
        now = time.time() if now is None else now
        acted = []
        for pr in provreqs:
            pr.expire_booking(now)
        pending = [
            pr for pr in provreqs
            if pr.class_name in SUPPORTED_CLASSES
            and not pr.has(PROVISIONED) and not pr.terminal()
        ]
        for pr in pending:
            pr.set_condition(ACCEPTED, True, "Supported", now)
            if pr.class_name == CHECK_CAPACITY_CLASS:
                ok = self.check_capacity(pr, nodes, scheduled_pods)
            else:
                ok = self.best_effort_atomic(pr, nodes, scheduled_pods, now)
            acted.append(pr.name)
            if ok:
                pr.set_condition(PROVISIONED, True, "CapacityAvailable", now)
            else:
                # check-capacity failure is terminal for this attempt window;
                # atomic failure is retried next loop (reference: checkcapacity
                # sets Failed, besteffortatomic keeps retrying under backoff)
                if pr.class_name == CHECK_CAPACITY_CLASS:
                    pr.set_condition(FAILED, True, "NotEnoughCapacity", now)
        return acted

    # ---- check-capacity (reference: checkcapacity/ — simulation only) ----

    def check_capacity(self, pr: ProvisioningRequest, nodes: list[Node],
                       scheduled_pods: list[Pod]) -> bool:
        enc = encode_cluster(
            nodes, scheduled_pods + pr.pods(), dims=self.dims,
            node_bucket=self.node_bucket, group_bucket=self.group_bucket,
            device=self.device,
        )
        packed = schedule_pending_on_existing(enc.nodes, enc.specs, enc.scheduled)
        total_pending = int(to_host(enc.specs.count).sum())
        return int(to_host(packed.scheduled).sum()) >= total_pending

    # ---- best-effort-atomic (reference: besteffortatomic/) ----

    def best_effort_atomic(self, pr: ProvisioningRequest, nodes: list[Node],
                           scheduled_pods: list[Pod], now: float) -> bool:
        # capacity may already exist — atomic requests first try to book it
        if self.check_capacity(pr, nodes, scheduled_pods):
            return True
        enc = encode_cluster(
            nodes, scheduled_pods + pr.pods(), dims=self.dims,
            node_bucket=self.node_bucket, group_bucket=self.group_bucket,
            device=self.device,
        )
        groups = [g for g in self.provider.node_groups() if g.exist()]
        if not groups:
            return False
        templates = [
            (g.template_node_info(), g.max_size() - g.target_size(),
             getattr(g, "price_per_node", 1.0))
            for g in groups
        ]
        group_tensors = encode_node_groups(
            templates, enc.registry, enc.zone_table, enc.dims,
            daemonsets=getattr(self, "daemonsets", None),
            device=self.device,
        )
        estimator = BinpackingEstimator(
            enc.dims, max_new_nodes_static=self.max_new_nodes_static
        )
        est = estimator.estimate_all_groups(enc.specs, group_tensors, len(nodes))
        total = int(to_host(enc.specs.count).sum())
        # group tensors are padded to the shape bucket; only real rows count
        scheduled = to_host(est.scheduled).sum(axis=1)[:len(groups)]
        node_count = to_host(est.node_count)[:len(groups)]
        for gi in np.argsort(node_count):                   # cheapest option first
            g = groups[int(gi)]
            if scheduled[gi] < total or node_count[gi] <= 0:
                continue
            if node_count[gi] > g.max_size() - g.target_size():
                continue
            try:
                g.atomic_increase_size(int(node_count[gi]))
                return True
            except NodeGroupError:
                continue
        return False


class ProvReqPodListProcessor:
    """Inject booked requests' pods into the pending list each loop so the
    reserved capacity is held until booking expiry (reference: the provreq
    injector turning accepted ProvReqs into fake pod lists)."""

    def __init__(self, list_provreqs):
        self.list_provreqs = list_provreqs

    def process(self, pods: list[Pod], ctx) -> list[Pod]:
        out = list(pods)
        for pr in self.list_provreqs():
            if pr.booked(ctx.now):
                out.extend(pr.pods())
        return out


class WrapperOrchestrator:
    """Alternate RunOnce loops between ProvisioningRequests and regular pods
    (reference: wrapper_orchestrator.go — the two-population split keeps a
    storm of ProvReqs from starving regular pending pods and vice versa)."""

    def __init__(self, provreq_orchestrator: ProvReqOrchestrator, list_provreqs):
        self.provreq = provreq_orchestrator
        self.list_provreqs = list_provreqs
        self._provreq_turn = False

    def maybe_run(self, nodes: list[Node], scheduled_pods: list[Pod],
                  now: float) -> list[str]:
        """Called once per loop; handles ProvReqs on alternating turns.
        Skips its turn (and keeps it) when there is nothing actionable.
        Booking expiry is checked EVERY loop — a lapsed booking must stop
        holding capacity immediately, not when the turn comes around."""
        reqs = self.list_provreqs()
        for r in reqs:
            r.expire_booking(now)
        self._provreq_turn = not self._provreq_turn
        if not self._provreq_turn:
            return []
        actionable = [
            r for r in reqs
            if r.class_name in SUPPORTED_CLASSES
            and not r.has(PROVISIONED) and not r.terminal()
        ]
        if not actionable:
            self._provreq_turn = False   # don't burn the next turn
            return []
        return self.provreq.run(reqs, nodes, scheduled_pods, now)

"""ClusterStateRegistry: node-group health, in-flight scale-ups, upcoming nodes.

Reference counterpart: clusterstate/clusterstate.go:122-156 — tracks per-group
scale-up requests (expiring into failures after max-node-provision-time),
readiness/acceptable ranges, unregistered and long-unregistered instances,
exponential backoff integration, and the upcoming-node counts the orchestrator
injects into the snapshot (GetUpcomingNodes :1104, consumed by
static_autoscaler.go:499 addUpcomingNodesToClusterSnapshot).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kubernetes_autoscaler_tpu_torch.cloudprovider.provider import CloudProvider, NodeGroup
from kubernetes_autoscaler_tpu_torch.config.options import AutoscalingOptions
from kubernetes_autoscaler_tpu_torch.models.api import Node
from kubernetes_autoscaler_tpu_torch.utils.backoff import ExponentialBackoff


@dataclass
class ScaleUpRequest:
    group_id: str
    increase: int
    time: float
    expected_add_time: float


@dataclass
class UnregisteredNode:
    name: str
    group_id: str
    since: float


@dataclass
class AcceptableRange:
    min_nodes: int
    max_nodes: int
    current_target: int


@dataclass
class Readiness:
    ready: int = 0
    unready: int = 0
    not_started: int = 0
    registered: int = 0


class ClusterStateRegistry:
    """Health model consulted by the orchestrators each loop."""

    def __init__(self, provider: CloudProvider, options: AutoscalingOptions):
        self.provider = provider
        self.options = options
        self.backoff = ExponentialBackoff(
            initial_s=options.initial_node_group_backoff_s,
            max_s=options.max_node_group_backoff_s,
            reset_timeout_s=options.node_group_backoff_reset_timeout_s,
        )
        self.scale_up_requests: dict[str, ScaleUpRequest] = {}
        self.scale_down_in_flight: dict[str, float] = {}   # node name -> since
        self.scale_down_group: dict[str, str] = {}         # node name -> group id
        self.readiness: dict[str, Readiness] = {}
        self.acceptable_ranges: dict[str, AcceptableRange] = {}
        self.unregistered: list[UnregisteredNode] = []
        self.failed_scale_ups: dict[str, float] = {}        # group -> last failure
        self.last_scale_up_time: float = 0.0
        self.last_scale_down_time: float = 0.0
        self.total_readiness = Readiness()

    # ---- scale-up bookkeeping (reference: RegisterOrUpdateScaleUp :242) ----

    def register_scale_up(self, group: NodeGroup, increase: int, now: float) -> None:
        prev = self.scale_up_requests.get(group.id())
        provision = self._max_provision_time(group)
        if prev:
            prev.increase += increase
            prev.expected_add_time = now + provision
        else:
            self.scale_up_requests[group.id()] = ScaleUpRequest(
                group.id(), increase, now, now + provision
            )
        self.last_scale_up_time = max(self.last_scale_up_time, now)

    def register_failed_scale_up(self, group: NodeGroup, now: float) -> None:
        from kubernetes_autoscaler_tpu_torch.metrics.metrics import default_registry

        default_registry.counter("failed_scale_ups_total").inc()
        tmpl = group.template_node_info()
        # specifically the provider's GPU resource — hugepages / DRA classes /
        # CSI attach-limit slots are extended resources too and must not
        # inflate the GPU failure metric
        if float(tmpl.alloc_or_cap().get(
                self.provider.gpu_resource_name(), 0)) > 0:
            default_registry.counter("failed_gpu_scale_ups_total").inc()
        """reference: RegisterFailedScaleUp → backoff the group."""
        self.failed_scale_ups[group.id()] = now
        self.backoff.backoff(group.id(), now)
        self.scale_up_requests.pop(group.id(), None)

    def register_scale_down(self, node_name: str, now: float,
                            group_id: str = "") -> None:
        self.scale_down_in_flight[node_name] = now
        self.scale_down_group[node_name] = group_id
        self.last_scale_down_time = max(self.last_scale_down_time, now)

    def _max_provision_time(self, group: NodeGroup) -> float:
        opts = group.get_options(_ng_defaults(self.options))
        return opts.max_node_provision_time_s or self.options.node_group_defaults.max_node_provision_time_s

    # ---- per-loop refresh (reference: UpdateNodes :421) ----

    def update_nodes(self, nodes: list[Node], now: float) -> None:
        registered = {n.name for n in nodes}
        # Scale-down completions: once a deleting node is gone from the
        # registered set, its in-flight entry is done (bounded memory; the
        # reference clears via NodeDeletionTracker result observation).
        self.scale_down_in_flight = {
            n: t for n, t in self.scale_down_in_flight.items() if n in registered
        }
        by_group: dict[str, Readiness] = {}
        known_unreg = {u.name: u for u in self.unregistered}
        total = Readiness()

        # Rebuild the unregistered list from what the cloud currently reports:
        # an instance that registered OR vanished from the provider drops out
        # (prevents re-reaping a long-gone instance every loop).
        still_unregistered: list[UnregisteredNode] = []
        for g in self.provider.node_groups():
            r = Readiness()
            for inst in g.nodes():
                if inst.name in registered:
                    continue
                r.not_started += 1
                prev = known_unreg.get(inst.name)
                still_unregistered.append(
                    prev if prev is not None
                    else UnregisteredNode(inst.name, g.id(), now)
                )
            by_group[g.id()] = r
        self.unregistered = still_unregistered

        self.node_first_seen = {
            n: t for n, t in getattr(self, "node_first_seen", {}).items()
            if n in registered}
        for nd in nodes:
            g = self.provider.node_group_for_node(nd)
            r = by_group.setdefault(g.id() if g else "", Readiness())
            r.registered += 1
            total.registered += 1
            # the node's own creation stamp when the source provides it
            # (reference: CreationTimestamp, clusterstate.go:739); fall back
            # to first-seen so fixture nodes without stamps still classify —
            # a restart must NOT re-open the startup window for old nodes
            since = (nd.creation_time if nd.creation_time > 0
                     else self.node_first_seen.setdefault(nd.name, now))
            if nd.ready:
                r.ready += 1
                total.ready += 1
            elif now - since <= self.options.max_node_startup_time_s:
                # within the startup window an unready node is "not started"
                # — it doesn't count against cluster health (reference:
                # clusterstate.go:739 CreationTimestamp + MaxNodeStartupTime)
                r.not_started += 1
                total.not_started += 1
            else:
                r.unready += 1
                total.unready += 1

        self.readiness = by_group
        self.total_readiness = total

        # expire fulfilled / timed-out scale-up requests
        for gid, req in list(self.scale_up_requests.items()):
            group = next((g for g in self.provider.node_groups() if g.id() == gid), None)
            if group is None:
                del self.scale_up_requests[gid]
                continue
            ready = by_group.get(gid, Readiness()).ready
            if ready >= group.target_size():
                del self.scale_up_requests[gid]
                self.backoff.remove_backoff(gid)
            elif now > req.expected_add_time:
                # timed out: nodes never came up (reference: updateScaleRequests)
                del self.scale_up_requests[gid]
                self.failed_scale_ups[gid] = now
                self.backoff.backoff(gid, now)

        self._update_acceptable_ranges()

    def _update_acceptable_ranges(self) -> None:
        """reference: updateAcceptableRanges (clusterstate.go) — per group,
        registered counts between target-minus-pending-adds and
        target-plus-in-flight-deletes are not 'incorrect size'."""
        sd_group = self.scale_down_group
        deleting_per_group: dict[str, int] = {}
        for node, _ in self.scale_down_in_flight.items():
            gid = sd_group.get(node, "")
            deleting_per_group[gid] = deleting_per_group.get(gid, 0) + 1
        for g in self.provider.node_groups():
            target = g.target_size()
            req = self.scale_up_requests.get(g.id())
            lo = target - (req.increase if req else 0)
            hi = target + deleting_per_group.get(g.id(), 0)
            self.acceptable_ranges[g.id()] = AcceptableRange(lo, hi, target)

    def has_incorrect_size(self, group_id: str) -> bool:
        """Registered count outside the acceptable range (consumed by
        fixNodeGroupSize-style reconciliation)."""
        rng = self.acceptable_ranges.get(group_id)
        r = self.readiness.get(group_id)
        if rng is None or r is None:
            return False
        return not (rng.min_nodes <= r.registered <= rng.max_nodes)

    # ---- health queries (reference: IsClusterHealthy :493) ----

    def is_cluster_healthy(self) -> bool:
        t = self.total_readiness
        unready = t.unready
        if t.registered == 0:
            return True
        if unready <= self.options.ok_total_unready_count:
            return True
        return unready * 100.0 / t.registered <= self.options.max_total_unready_percentage

    def is_node_group_safe_to_scale_up(self, group: NodeGroup, now: float) -> bool:
        if self.backoff.is_backed_off(group.id(), now):
            return False
        return self.is_node_group_healthy(group.id())

    def is_node_group_healthy(self, group_id: str) -> bool:
        r = self.readiness.get(group_id)
        if r is None:
            return True
        unready = r.unready
        if r.registered == 0:
            return True
        if unready <= self.options.ok_total_unready_count:
            return True
        return unready * 100.0 / r.registered <= self.options.max_total_unready_percentage

    # ---- upcoming nodes (reference: GetUpcomingNodes :1104) ----

    def upcoming_nodes(self) -> dict[str, int]:
        """Per group: target - ready-registered = nodes expected to appear."""
        out: dict[str, int] = {}
        for g in self.provider.node_groups():
            r = self.readiness.get(g.id(), Readiness())
            upcoming = g.target_size() - r.registered
            if upcoming > 0:
                out[g.id()] = upcoming
        return out

    def long_unregistered(self, now: float) -> list[UnregisteredNode]:
        cutoff = self.options.unregistered_node_removal_time_s
        return [u for u in self.unregistered if now - u.since > cutoff]


def _ng_defaults(options: AutoscalingOptions):
    from kubernetes_autoscaler_tpu_torch.cloudprovider.provider import NodeGroupOptions

    d = options.node_group_defaults
    return NodeGroupOptions(
        scale_down_utilization_threshold=d.scale_down_utilization_threshold,
        scale_down_gpu_utilization_threshold=d.scale_down_gpu_utilization_threshold,
        scale_down_unneeded_time_s=d.scale_down_unneeded_time_s,
        scale_down_unready_time_s=d.scale_down_unready_time_s,
        max_node_provision_time_s=d.max_node_provision_time_s,
        ignore_daemonsets_utilization=d.ignore_daemonsets_utilization,
    )

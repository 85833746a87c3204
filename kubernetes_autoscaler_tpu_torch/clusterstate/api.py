"""ClusterAutoscalerStatus: the human/machine-readable status document.

Reference counterpart: clusterstate/api/types.go (SURVEY.md §2.7) — the
`ClusterAutoscalerStatus` object serialized to YAML into the
`cluster-autoscaler-status` ConfigMap after every loop
(static_autoscaler.go:418-421, clusterstate/utils WriteStatusConfigMap):
cluster-wide and per-node-group Health / ScaleUp / ScaleDown conditions with
readiness counts and min/max/target sizes.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from kubernetes_autoscaler_tpu_torch.clusterstate.registry import (
    ClusterStateRegistry,
    Readiness,
)

# Condition class values (reference: api/types.go ClusterAutoscalerConditionStatus)
HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"
IN_PROGRESS = "InProgress"
NO_ACTIVITY = "NoActivity"
BACKOFF = "Backoff"
CANDIDATES_PRESENT = "CandidatesPresent"
NO_CANDIDATES = "NoCandidates"


@dataclass
class NodeCounts:
    ready: int = 0
    unready: int = 0
    not_started: int = 0
    registered: int = 0

    @classmethod
    def from_readiness(cls, r: Readiness) -> "NodeCounts":
        return cls(ready=r.ready, unready=r.unready,
                   not_started=r.not_started, registered=r.registered)


@dataclass
class NodeGroupStatus:
    name: str
    health: str = HEALTHY
    scale_up: str = NO_ACTIVITY
    scale_down: str = NO_CANDIDATES
    node_counts: NodeCounts = field(default_factory=NodeCounts)
    min_size: int = 0
    max_size: int = 0
    target_size: int = 0


@dataclass
class ClusterAutoscalerStatus:
    autoscaler_status: str = HEALTHY
    # identity of the ConfigMap this document is written as (reference:
    # --status-config-map-name names the object WriteStatusConfigMap updates)
    config_map_name: str = "cluster-autoscaler-status"
    cluster_wide: NodeGroupStatus = field(
        default_factory=lambda: NodeGroupStatus(name="")
    )
    node_groups: list[NodeGroupStatus] = field(default_factory=list)
    last_probe_time: float = 0.0
    message: str = ""
    # reason plane: per-reason verdict histograms for this loop — WHY pods
    # stayed pending (ops/predicates reason taxonomy + no-node-in-group) and
    # WHY nodes stayed unremovable (the reference unremovable enum strings,
    # UnremovableNodes.reason_counts). Empty dicts when everything scheduled
    # / every candidate drained.
    unschedulable_reasons: dict[str, int] = field(default_factory=dict)
    unremovable_reasons: dict[str, int] = field(default_factory=dict)

    def to_dict(self) -> dict:
        def ng(s: NodeGroupStatus) -> dict:
            return {
                "name": s.name,
                "health": {
                    "status": s.health,
                    "nodeCounts": vars(s.node_counts),
                    "minSize": s.min_size,
                    "maxSize": s.max_size,
                    "targetSize": s.target_size,
                },
                "scaleUp": {"status": s.scale_up},
                "scaleDown": {"status": s.scale_down},
            }

        doc = {
            "configMapName": self.config_map_name,
            "autoscalerStatus": self.autoscaler_status,
            "message": self.message,
            "lastProbeTime": self.last_probe_time,
            "clusterWide": ng(self.cluster_wide),
            "nodeGroups": [ng(s) for s in self.node_groups],
        }
        doc["clusterWide"]["scaleUp"]["unschedulableReasons"] = dict(
            self.unschedulable_reasons)
        doc["clusterWide"]["scaleDown"]["unremovableReasons"] = dict(
            self.unremovable_reasons)
        return doc

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)


def build_status(registry: ClusterStateRegistry, now: float,
                 scale_down_candidates: list[str] | None = None,
                 config_map_name: str | None = None,
                 unschedulable_reasons: dict[str, int] | None = None,
                 unremovable_reasons: dict[str, int] | None = None,
                 ) -> ClusterAutoscalerStatus:
    """Assemble the status document from the registry's health model
    (reference: clusterstate.GetStatus). The optional reason histograms come
    from the loop's reason plane — the orchestrator's NoScaleUp totals and
    the planner's UnremovableNodes cache — so the status ConfigMap carries
    the same per-reason verdicts the events and metrics do."""
    st = ClusterAutoscalerStatus(last_probe_time=now)
    if config_map_name:
        st.config_map_name = config_map_name
    if unschedulable_reasons:
        st.unschedulable_reasons = dict(unschedulable_reasons)
    if unremovable_reasons:
        st.unremovable_reasons = dict(unremovable_reasons)
    st.cluster_wide.node_counts = NodeCounts.from_readiness(
        registry.total_readiness
    )
    st.cluster_wide.health = (
        HEALTHY if registry.is_cluster_healthy() else UNHEALTHY
    )
    if registry.scale_up_requests:
        st.cluster_wide.scale_up = IN_PROGRESS
    if registry.scale_down_in_flight:
        st.cluster_wide.scale_down = CANDIDATES_PRESENT
    elif scale_down_candidates:
        st.cluster_wide.scale_down = CANDIDATES_PRESENT

    for g in registry.provider.node_groups():
        gid = g.id()
        s = NodeGroupStatus(
            name=gid,
            min_size=g.min_size(), max_size=g.max_size(),
            target_size=g.target_size(),
            node_counts=NodeCounts.from_readiness(
                registry.readiness.get(gid, Readiness())
            ),
        )
        s.health = HEALTHY if registry.is_node_group_healthy(gid) else UNHEALTHY
        if registry.backoff.is_backed_off(gid, now):
            s.scale_up = BACKOFF
        elif gid in registry.scale_up_requests:
            s.scale_up = IN_PROGRESS
        in_flight_groups = set(registry.scale_down_group.values())
        if gid in in_flight_groups:
            s.scale_down = CANDIDATES_PRESENT
        st.node_groups.append(s)

    if st.cluster_wide.health == UNHEALTHY:
        st.autoscaler_status = UNHEALTHY
    return st

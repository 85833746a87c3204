"""VPA object model: the VerticalPodAutoscaler CRD surface.

Reference counterpart: vertical-pod-autoscaler/pkg/apis/autoscaling.k8s.io/v1
types — VPA spec (target ref, update policy, per-container resource policy)
and status (recommendation with target/lower/upper/uncapped bounds).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum


class UpdateMode(Enum):
    OFF = "Off"
    INITIAL = "Initial"
    RECREATE = "Recreate"
    AUTO = "Auto"
    IN_PLACE_OR_RECREATE = "InPlaceOrRecreate"


@dataclass
class ContainerResourcePolicy:
    container_name: str = "*"
    mode: str = "Auto"                    # Auto | Off
    min_allowed: dict[str, float] = field(default_factory=dict)   # cpu cores, memory bytes
    max_allowed: dict[str, float] = field(default_factory=dict)
    controlled_values: str = "RequestsAndLimits"


@dataclass
class RecommendedContainerResources:
    container_name: str
    target: dict[str, float] = field(default_factory=dict)
    lower_bound: dict[str, float] = field(default_factory=dict)
    upper_bound: dict[str, float] = field(default_factory=dict)
    uncapped_target: dict[str, float] = field(default_factory=dict)


@dataclass
class VerticalPodAutoscaler:
    name: str
    namespace: str = "default"
    target_kind: str = "Deployment"
    target_name: str = ""
    update_mode: UpdateMode = UpdateMode.AUTO
    min_replicas: int = 2
    resource_policies: list[ContainerResourcePolicy] = field(default_factory=list)
    recommendation: list[RecommendedContainerResources] = field(default_factory=list)

    def policy_for(self, container: str) -> ContainerResourcePolicy:
        star = ContainerResourcePolicy()
        for p in self.resource_policies:
            if p.container_name == container:
                return p
            if p.container_name == "*":
                star = p
        return star


@dataclass
class ContainerUsageSample:
    """One metrics observation (reference: model.ContainerUsageSample)."""

    namespace: str
    pod_name: str
    container_name: str
    owner_name: str              # controller identity (aggregation key part)
    cpu_cores: float | None = None
    memory_bytes: float | None = None
    is_oom: bool = False
    timestamp: float = 0.0

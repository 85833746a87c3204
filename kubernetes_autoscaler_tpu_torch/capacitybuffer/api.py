"""CapacityBuffer API: headroom expressed as pod templates.

Reference counterpart: cluster-autoscaler/apis/capacitybuffer/.../v1beta1
(the CapacityBuffer CRD) and SURVEY.md §2.7 — a buffer describes spare
capacity the autoscaler must hold: either an explicit pod template ×
replicas, or a percentage of a scalable workload's replica count. The
controller translates active buffers into fake pending pods injected every
loop so scale-up provisions the headroom before real pods need it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kubernetes_autoscaler_tpu_torch.models.api import Pod, Workload

# ProvisioningStrategy values (reference: v1beta1 types — only the active
# strategy triggers injection; others park the buffer).
ACTIVE_PROVISIONING_STRATEGY = "buffer.x-k8s.io/active-capacity"

# Condition types mirrored from the reference's status handling.
READY_FOR_PROVISIONING = "ReadyForProvisioning"
PROVISIONING = "Provisioning"


@dataclass
class BufferStatus:
    """reference: CapacityBufferStatus — resolved template + replica count
    plus conditions explaining why a buffer is (not) being provisioned, and
    the generation bookkeeping that lets reconciles skip unchanged specs."""

    pod_template: Optional[Pod] = None
    replicas: int = 0
    conditions: dict[str, str] = field(default_factory=dict)  # type -> True/False/reason
    observed_generation: int = 0          # reference: Status.ObservedGeneration
    pod_template_generation: int = 0      # reference: Status.PodTemplateGeneration

    def ready(self) -> bool:
        return self.conditions.get(READY_FOR_PROVISIONING) == "True"


@dataclass
class CapacityBuffer:
    """One buffer object. Exactly one of `pod_template` / `scalable_ref`
    drives translation (reference: spec.podTemplateRef vs spec.scalableRef)."""

    name: str
    namespace: str = "default"
    pod_template: Optional[Pod] = None
    replicas: Optional[int] = None
    # percentage of a scalable workload's desired replicas (scalableRef path)
    scalable_ref: Optional[Workload] = None
    percentage: Optional[float] = None
    # minimum replicas when percentage rounds down to zero
    limits_min_replicas: int = 0
    provisioning_strategy: str = ACTIVE_PROVISIONING_STRATEGY
    # spec generation, bumped by whoever mutates the spec (the CRD machinery
    # in the reference); reconcile skips generations it already observed
    generation: int = 1
    # pod-template object generation (reference: PodTemplate.Generation)
    pod_template_generation: int = 1
    status: BufferStatus = field(default_factory=BufferStatus)

    def bump(self) -> None:
        """Test/fixture helper: record a spec mutation."""
        self.generation += 1

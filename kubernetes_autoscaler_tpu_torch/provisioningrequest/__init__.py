from kubernetes_autoscaler_tpu_torch.provisioningrequest.api import (
    BEST_EFFORT_ATOMIC_CLASS,
    CHECK_CAPACITY_CLASS,
    PodSet,
    ProvisioningRequest,
)
from kubernetes_autoscaler_tpu_torch.provisioningrequest.orchestrator import (
    ProvReqOrchestrator,
    WrapperOrchestrator,
)

__all__ = [
    "BEST_EFFORT_ATOMIC_CLASS",
    "CHECK_CAPACITY_CLASS",
    "PodSet",
    "ProvisioningRequest",
    "ProvReqOrchestrator",
    "WrapperOrchestrator",
]

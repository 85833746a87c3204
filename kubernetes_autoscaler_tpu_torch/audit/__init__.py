from kubernetes_autoscaler_tpu_torch.audit.shadow import (  # noqa: F401
    AUDIT_CHECKS_HELP,
    AUDIT_SURFACES,
    ShadowAuditor,
    sample_indices,
)

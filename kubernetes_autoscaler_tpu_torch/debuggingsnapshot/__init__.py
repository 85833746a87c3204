from kubernetes_autoscaler_tpu_torch.debuggingsnapshot.snapshotter import (
    DebuggingSnapshotter,
)

__all__ = ["DebuggingSnapshotter"]

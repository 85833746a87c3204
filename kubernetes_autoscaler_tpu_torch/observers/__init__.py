from kubernetes_autoscaler_tpu_torch.observers.nodegroupchange import (
    NodeGroupChangeObserverList,
)

__all__ = ["NodeGroupChangeObserverList"]

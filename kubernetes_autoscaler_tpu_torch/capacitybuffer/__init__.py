from kubernetes_autoscaler_tpu_torch.capacitybuffer.api import (
    BufferStatus,
    CapacityBuffer,
)
from kubernetes_autoscaler_tpu_torch.capacitybuffer.controller import BufferController
from kubernetes_autoscaler_tpu_torch.capacitybuffer.translators import translate_buffer

__all__ = [
    "BufferController",
    "BufferStatus",
    "CapacityBuffer",
    "translate_buffer",
]

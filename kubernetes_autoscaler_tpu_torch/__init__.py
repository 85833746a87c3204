"""PyTorch/CUDA port of the cluster-autoscaling simulation framework.

The JAX package `kubernetes_autoscaler_tpu` is the reference; this package
computes the same tensors with PyTorch, and its FFD pack runs as a CUDA
kernel written for Hopper (csrc/pack.cu). Layout mirrors the reference:
`models/` (object model, encoder, tensor state), `ops/` (the device
program), `ops/kernels/` (kernel wrappers and their plain versions),
`csrc/` (CUDA sources).

Nothing here imports JAX or the reference package. Entry points that
build tensors take `device=None`, which means CUDA, and raise when no CUDA
device is present unless the caller passes `device="cpu"`.
"""

from kubernetes_autoscaler_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]

"""PyTorch/CUDA port of the cluster-autoscaling simulation framework.

The JAX package `kubernetes_autoscaler_tpu` is the reference; this package
computes the same tensors with PyTorch, and its pack kernels run as CUDA
kernels written for Hopper (csrc/). Layout mirrors the reference:
`core/` (the control loop, `StaticAutoscaler`, with its planner and
orchestrators), `models/` (object model, encoder, tensor state, the
resident world store), `ops/` (the device program), `ops/kernels/` (kernel
wrappers and their plain versions), `csrc/` (CUDA sources), and copies of
the reference's host-only modules the loop reaches.

Nothing here imports JAX or the reference package. Entry points that
build tensors take `device=None`, which means CUDA, and raise when no CUDA
device is present unless the caller passes `device="cpu"`.
"""

from kubernetes_autoscaler_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]

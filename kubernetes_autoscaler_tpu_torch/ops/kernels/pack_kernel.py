"""K1, the batched FFD pack: the wrapper of the CUDA kernel and its plain
PyTorch version.

Replaces the reference package's `ops/pallas/pack_kernel.py`
(`pack_groups_batched`, whose body is the Pallas `_pack_kernel`). The
kernel itself is `csrc/pack.cu`; its header says what bounds it and how its
design answers that (one CTA per batch row, coalesced lanes, dead groups
skipped, one barrier per live group).

The device of the tensors decides: CPU tensors go through
`pack_groups_batched_plain`, CUDA tensors through the kernel, and anything
the kernel does not take raises. There is no fallback from the kernel to
the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kubernetes_autoscaler_tpu_torch.ops.bitplane import pack_group_bits
from kubernetes_autoscaler_tpu_torch.ops.pack import PackResult, fit_count

SOURCE = "pack.cu"


def pack_groups_batched_plain(
    free: torch.Tensor,       # i32[B, N, R] starting free capacity per row
    mask: torch.Tensor,       # bool[B, G, N] placement-independent feasibility
    req: torch.Tensor,        # i32[G, R]
    count: torch.Tensor,      # i32[G]
    order: torch.Tensor,      # i32[G] permutation of 0..G-1
    limit_one: torch.Tensor,  # bool[G]
) -> PackResult:
    """The plain version: a Python loop over `order`, each step one prefix
    sum over the node axis of every batch row (torch.cumsum, int64)."""
    b, n, r = free.shape
    g_total = req.shape[0]
    free_c = free.clone()
    placed = torch.zeros((b, g_total, n), dtype=torch.int32, device=free.device)
    counts = count.tolist()
    limits = limit_one.tolist()
    for g in order.tolist():
        reqg = req[g]
        c = fit_count(free_c, reqg)                          # i32[B, N]
        c = torch.where(mask[:, g, :], c, 0)
        if limits[g]:
            c = c.clamp(max=1)
        c = c.clamp(max=counts[g])
        cum = torch.cumsum(c, dim=1)                         # i64[B, N]
        place = torch.minimum((counts[g] - (cum - c)).clamp(min=0), c)
        place = place.to(torch.int32)
        free_c = free_c - place[:, :, None] * reqg
        placed[:, g, :] = place
    return PackResult(free_after=free_c, placed=placed,
                      scheduled=placed.sum(dim=-1, dtype=torch.int32))


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.cache
def _entry():
    """The kernel's C entry point, loaded (and built if needed) and typed
    once per process."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels.build import load

    fn = load(SOURCE).ka_pack_groups_batched
    # every pointer and the stream as c_void_p: ctypes would cut them to int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pack_groups_batched(
    free: torch.Tensor,       # i32[B, N, R]
    mask: torch.Tensor,       # bool[B, G, N]
    req: torch.Tensor,        # i32[G, R]
    count: torch.Tensor,      # i32[G]
    order: torch.Tensor,      # i32[G] permutation of 0..G-1
    limit_one: torch.Tensor,  # bool[G]
) -> PackResult:
    """Batched FFD pack; batch rows are independent. CPU tensors take the
    plain version, CUDA tensors the kernel (one launch, counted in
    `pack_groups_batched.launches`). Returns a PackResult with a leading
    batch axis on every field. The inputs are checked against the
    kernel's contract on either device, so the CPU tests hold callers to
    it too."""
    b, n, r = free.shape
    g = req.shape[0]
    dev = free.device
    _check("free", free, torch.int32, (b, n, r), dev)
    _check("mask", mask, torch.bool, (b, g, n), dev)
    _check("req", req, torch.int32, (g, r), dev)
    _check("count", count, torch.int32, (g,), dev)
    _check("order", order, torch.int32, (g,), dev)
    _check("limit_one", limit_one, torch.bool, (g,), dev)
    if dev.type == "cpu":
        return pack_groups_batched_plain(free, mask, req, count, order,
                                         limit_one)
    if dev.type != "cuda":
        raise ValueError(f"pack_groups_batched: no kernel for {dev}")

    with torch.cuda.device(dev):
        return launch(free, pack_group_bits(mask), req, count, order,
                      limit_one.to(torch.int32))


def launch(free, mask_bits, req, count, order, limit_one) -> PackResult:
    """One launch of the kernel on checked CUDA tensors, with the mask
    already bit-packed (i32[B, ceil(G/32), N]) and limit_one as i32[G].
    Counted in `pack_groups_batched.launches`."""
    b, n, r = free.shape
    g = req.shape[0]
    dev = free.device
    placed = torch.empty((b, g, n), dtype=torch.int32, device=dev)
    free_after = torch.empty_like(free)
    scheduled = torch.empty((b, g), dtype=torch.int32, device=dev)
    rc = _entry()(
        free.data_ptr(), mask_bits.data_ptr(), req.data_ptr(),
        count.data_ptr(), order.data_ptr(), limit_one.data_ptr(),
        placed.data_ptr(), free_after.data_ptr(), scheduled.data_ptr(),
        b, g, n, r, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pack kernel launch failed: CUDA error {rc}")
    pack_groups_batched.launches += 1
    return PackResult(free_after=free_after, placed=placed, scheduled=scheduled)


pack_groups_batched.launches = 0

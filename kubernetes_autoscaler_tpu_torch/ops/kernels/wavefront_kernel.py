"""K2, the segmented wavefront pack: the wrapper of the CUDA kernel and its
plain PyTorch version.

Replaces the reference package's `ops/pallas/pack_kernel.py`
(`pack_groups_wavefront_pallas` → `_wavefront_call`, whose body is the
Pallas `_wavefront_kernel`). The kernel itself is `csrc/wavefront.cu`.

The function, for each wave w of `waves` (i32[W, S], -1 = empty slot) and
each slot with group g = waves[w, s] ≥ 0: the fit of every node lane is
taken against the free capacity at the START of the wave, masked, capped at
one per node for `limit_one` groups and clamped to the count; the prefix sum
over the lanes places the count first-fit; the slots' placements × requests
sum into one delta, and the free capacity drops by it once per wave. A
group occupies at most one slot of the whole plan (checked). For a plan
built from a superset of the mask the waves' masks are disjoint and the
result equals the serial pack.

What bounds the kernel is serial depth, W waves each a prefix sum over the
node lanes, not bytes. It launches one thread-block cluster (C = 16 CTAs
where the card can schedule that many at the launch's size, else 8;
`config` says which). CTA c owns a contiguous range of node lanes and keeps
them, and their working free capacity, in its shared memory; in each wave
every CTA runs every live slot over its own lanes (the division-free fit
and saturating scan of K1, `csrc/pack_row.cuh`), the CTAs exchange each
slot's per-CTA total through distributed shared memory across one cluster
barrier, then place and apply the wave's summed update locally. A range
too large for shared memory keeps its plane in `free_after`. The wrapper
allocates nothing but the outputs.

The device of the tensors decides: CPU tensors go through
`pack_groups_wavefront_plain`, CUDA tensors through the kernel, and
anything the kernel does not take raises, as does a launch the card cannot
schedule (its CUDA error). There is no fallback from the kernel to the
plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kubernetes_autoscaler_tpu_torch.ops.bitplane import pack_group_bits
from kubernetes_autoscaler_tpu_torch.ops.kernels.pack_kernel import _check
from kubernetes_autoscaler_tpu_torch.ops.pack import PackResult, fit_count

SOURCE = "wavefront.cu"


def pack_groups_wavefront_plain(
    free: torch.Tensor,       # i32[N, R] starting free capacity
    mask: torch.Tensor,       # bool[G, N] placement-independent feasibility
    req: torch.Tensor,        # i32[G, R]
    count: torch.Tensor,      # i32[G]
    limit_one: torch.Tensor,  # bool[G]
    waves: torch.Tensor,      # i32[W, S] group ids, -1 = empty slot
) -> PackResult:
    """The plain version: a Python loop over the W waves, each step the
    whole wave's [S, N] fits and one prefix sum over the node axis per slot
    (torch.cumsum, int64), then one summed update of the free capacity."""
    g_total, n = mask.shape
    free_c = free.clone()
    placed = torch.zeros((g_total, n), dtype=torch.int32, device=free.device)
    for w in range(waves.shape[0]):
        wave = waves[w]
        slot_ok = wave >= 0
        gid = wave.clamp(min=0).long()
        reqw = req[gid]                                          # i32[S, R]
        cntw = torch.where(slot_ok, count[gid], 0)
        c = fit_count(free_c, reqw)                              # i32[S, N]
        c = torch.where(mask[gid] & slot_ok[:, None], c, 0)
        c = torch.where(limit_one[gid][:, None], c.clamp(max=1), c)
        c = torch.minimum(c, cntw[:, None])
        cum = torch.cumsum(c, dim=1)                             # i64[S, N]
        place = torch.minimum((cntw[:, None] - (cum - c)).clamp(min=0), c)
        place = place.to(torch.int32)
        # empty slots carry all-zero rows, so the add is a scatter-set; the
        # summed update wraps in int32 as the reference's does
        delta = (place[:, :, None].to(torch.int64)
                 * reqw[:, None, :].to(torch.int64)).sum(dim=0)
        free_c = free_c - delta.to(torch.int32)
        placed.index_add_(0, gid, place)
    return PackResult(free_after=free_c, placed=placed,
                      scheduled=placed.sum(dim=-1, dtype=torch.int32))


def _check_waves(waves: torch.Tensor, g: int) -> None:
    """Every id in [-1, G), and no group in two slots. The ids live on the
    tensor's device, so the check reads them back to the host (a wait for
    the queued work); a plan's `waves` is the same tensor from step to
    step, so the result is kept on the tensor, keyed by its in-place
    version counter, and each tensor is read once per version and G."""
    key = (waves._version, g)
    if getattr(waves, "_wave_ids_checked", None) == key:
        return
    ids = waves.reshape(-1).long()
    if ids.numel():
        uses = torch.zeros((g + 1,), dtype=torch.int64, device=ids.device)
        uses.index_add_(0, (ids + 1).clamp(0, g), torch.ones_like(ids))
        most = uses[1:].max() if g else torch.zeros_like(ids[0])
        lo, hi, most = torch.stack([*torch.aminmax(ids), most]).tolist()
        if lo < -1 or hi >= g:
            raise ValueError(f"waves holds group ids in [{lo}, {hi}], "
                             f"expected [-1, {g})")
        if most > 1:
            raise ValueError("waves holds a group in more than one slot")
    waves._wave_ids_checked = key


@functools.cache
def _entry():
    """The kernel's C entry point, loaded (and built if needed) and typed
    once per process."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels.build import load

    lib = load(SOURCE)
    fn = lib.ka_pack_groups_wavefront
    # every pointer and the stream as c_void_p: ctypes would cut them to int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cfg = lib.ka_wavefront_config
    cfg.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    cfg.restype = ctypes.c_int
    return fn, cfg


PLACEMENTS = {1: "device memory", 2: "shared memory"}


def config(g: int, n: int, r: int, w: int, cluster: int = 0,
           placement: int = 0, device=None) -> dict:
    """What a launch at these shapes uses on `device` (default: the current
    CUDA device): {"cluster": C (the CTAs launched), "threads": threads a
    CTA, "smem": dynamic shared-memory bytes, "plane": where each CTA keeps
    its lanes of the working free plane (a PLACEMENTS name)}. `cluster` and `placement` 0 let
    the launcher choose, as the wrapper does."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device if device is not None
                           else torch.cuda.current_device()):
        rc = _entry()[1](g, n, r, w, cluster, placement, out)
    if rc != 0:
        raise RuntimeError(f"wavefront kernel configuration failed: CUDA error {rc}")
    return {"cluster": out[0], "threads": out[1], "smem": out[2],
            "plane": PLACEMENTS[2 if out[3] else 1]}


def pack_groups_wavefront(
    free: torch.Tensor,       # i32[N, R]
    mask: torch.Tensor,       # bool[G, N]
    req: torch.Tensor,        # i32[G, R]
    count: torch.Tensor,      # i32[G]
    limit_one: torch.Tensor,  # bool[G]
    waves: torch.Tensor,      # i32[W, S]
) -> PackResult:
    """Segmented wavefront pack. CPU tensors take the plain version, CUDA
    tensors the kernel (one launch, counted in
    `pack_groups_wavefront.launches`). The inputs are checked against the
    kernel's contract on either device, so the CPU tests hold callers to
    it too."""
    n, r = free.shape
    g = req.shape[0]
    dev = free.device
    _check("free", free, torch.int32, (n, r), dev)
    _check("mask", mask, torch.bool, (g, n), dev)
    _check("req", req, torch.int32, (g, r), dev)
    _check("count", count, torch.int32, (g,), dev)
    _check("limit_one", limit_one, torch.bool, (g,), dev)
    if waves.dim() != 2:
        raise ValueError(f"waves has shape {tuple(waves.shape)}, expected [W, S]")
    _check("waves", waves, torch.int32, tuple(waves.shape), dev)
    _check_waves(waves, g)
    if dev.type == "cpu":
        return pack_groups_wavefront_plain(free, mask, req, count, limit_one,
                                           waves)
    if dev.type != "cuda":
        raise ValueError(f"pack_groups_wavefront: no kernel for {dev}")

    with torch.cuda.device(dev):
        return launch(free, pack_group_bits(mask), req, count,
                      limit_one.to(torch.int32), waves)


def launch(free, mask_bits, req, count, limit_one, waves, cluster: int = 0,
           placement: int = 0) -> PackResult:
    """One launch of the kernel on checked CUDA tensors, with the mask
    already bit-packed (i32[ceil(G/32), N]) and limit_one as i32[G].
    `cluster` 0 lets the launcher choose the cluster size, 1 to 16 forces
    it; `placement` 0 lets it choose where each CTA keeps its lanes of the
    working free plane, 1 forces device memory and 2 shared memory (forced
    only to measure and test each variant). Counted in
    `pack_groups_wavefront.launches`."""
    n, r = free.shape
    g = req.shape[0]
    w, s = waves.shape
    dev = free.device
    placed = torch.empty((g, n), dtype=torch.int32, device=dev)
    free_after = torch.empty_like(free)
    scheduled = torch.empty((g,), dtype=torch.int32, device=dev)
    rc = _entry()[0](
        free.data_ptr(), mask_bits.data_ptr(), req.data_ptr(),
        count.data_ptr(), limit_one.data_ptr(), waves.data_ptr(),
        placed.data_ptr(), free_after.data_ptr(), scheduled.data_ptr(),
        g, n, r, w, s, cluster, placement,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wavefront kernel launch failed: CUDA error {rc}")
    pack_groups_wavefront.launches += 1
    return PackResult(free_after=free_after, placed=placed, scheduled=scheduled)


pack_groups_wavefront.launches = 0

"""The VPA histogram scatter: the wrapper of the CUDA kernel and its plain
PyTorch version.

Replaces XLA's scatter-add in the reference package's `vpa/histogram.py`
(`_scatter_add`, `.at[agg, bucket].add(w)` and `.at[agg].add(w)`), which
has no Pallas kernel. XLA's CPU adds each bin's samples in sample order,
starting from the bin's current value; the port must sum in that order on
both devices, because a percentile is the bucket end where a running sum
crosses a quantile. The kernel is `csrc/histogram.cu`; its header says what
bounds it and how it keeps the order.

The device of the tensors decides: CPU tensors go through
`scatter_add_ordered_plain` (`index_add_`, a sequential loop in sample
order on the CPU), CUDA tensors through the kernel (an atomic
`index_add_` on the card sums in no fixed order), and anything the kernel
does not take raises on either device, an aggregate or a bucket outside
the bank included. There is no fallback from the kernel to the plain
version. Both update the bank's tensors in place.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kubernetes_autoscaler_tpu_torch.ops.hostfetch import to_host

SOURCE = "histogram.cu"


def scatter_add_ordered_plain(weights: torch.Tensor, total: torch.Tensor,
                              agg: torch.Tensor, bucket: torch.Tensor,
                              w: torch.Tensor) -> None:
    """The plain version: `index_add_` on the flat bin index `agg *
    n_buckets + bucket` and on `agg`. On the CPU it adds in sample order,
    as XLA's CPU scatter does (`index_put_(accumulate=True)` does not)."""
    n_buckets = weights.shape[1]
    flat = agg.long() * n_buckets + bucket.long()
    weights.view(-1).index_add_(0, flat, w)
    total.index_add_(0, agg.long(), w)


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

    fn = load(SOURCE).ka_hist_scatter
    # every pointer and the stream as c_void_p: ctypes would cut them to int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int,
                                            ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def scatter_add_ordered(weights: torch.Tensor,  # f32[A, B], updated in place
                        total: torch.Tensor,    # f32[A], updated in place
                        agg: torch.Tensor,      # i32[n] aggregate row
                        bucket: torch.Tensor,   # i32[n] bucket, in [0, B)
                        w: torch.Tensor,        # f32[n] sample weight
                        ) -> None:
    """weights[agg[i], bucket[i]] += w[i] and total[agg[i]] += w[i] for
    every sample i, each bin and each total summed in sample order. CPU
    tensors take the plain version, CUDA tensors the kernel (one launch,
    counted in `scatter_add_ordered.launches`). The inputs are checked
    against the kernel's contract on either device: on the card that costs
    one read of four integers (the least and greatest aggregate and bucket),
    made after the sort."""
    a, b = weights.shape
    n = agg.shape[0]
    dev = weights.device
    _check("weights", weights, torch.float32, (a, b), dev)
    _check("total", total, torch.float32, (a,), dev)
    _check("agg", agg, torch.int32, (n,), dev)
    _check("bucket", bucket, torch.int32, (n,), dev)
    _check("w", w, torch.float32, (n,), dev)
    if n == 0:
        return
    if dev.type == "cpu":
        _check_range(agg.min(), agg.max(), *bucket.aminmax(), a, b)
        scatter_add_ordered_plain(weights, total, agg, bucket, w)
        return
    if dev.type != "cuda":
        raise ValueError(f"scatter_add_ordered: no kernel for {dev}")
    with torch.cuda.device(dev):
        sorted_agg, order = torch.sort(agg, stable=True)
        _check_range(*to_host(torch.stack([sorted_agg[0], sorted_agg[-1],
                                           *bucket.aminmax()])), a, b)
        launch(sorted_agg, order, bucket, w, weights, total)


def _check_range(agg_lo, agg_hi, b_lo, b_hi, a: int, b: int) -> None:
    if agg_lo < 0 or agg_hi >= a:
        raise ValueError(f"aggregates [{int(agg_lo)}, {int(agg_hi)}] outside "
                         f"the bank's rows [0, {a})")
    if b_lo < 0 or b_hi >= b:
        raise ValueError(f"buckets [{int(b_lo)}, {int(b_hi)}] outside "
                         f"[0, {b})")


def launch(sorted_agg, order, bucket, w, weights, total) -> None:
    """One launch of the kernel on checked CUDA tensors (every aggregate
    and bucket inside the bank), the samples' aggregates already sorted
    stably (`order`: i64 sample index of each place). Counted in
    `scatter_add_ordered.launches`."""
    n = sorted_agg.shape[0]
    rc = _entry()(
        sorted_agg.data_ptr(), order.data_ptr(), bucket.data_ptr(),
        w.data_ptr(), weights.data_ptr(), total.data_ptr(), n,
        weights.shape[1],
        torch.cuda.current_stream(weights.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"histogram scatter launch failed: CUDA error {rc}")
    scatter_add_ordered.launches += 1


scatter_add_ordered.launches = 0

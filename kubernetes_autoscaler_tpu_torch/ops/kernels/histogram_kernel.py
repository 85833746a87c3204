"""The VPA histogram scatter: the wrapper of the CUDA kernel and its plain
PyTorch version.

Replaces XLA's scatter-add in the reference package's `vpa/histogram.py`
(`_scatter_add`, `.at[agg, bucket].add(w)` and `.at[agg].add(w)`), which
has no Pallas kernel. XLA's CPU adds each bin's samples in sample order,
starting from the bin's current value; the port must sum in that order on
both devices, because a percentile is the bucket end where a running sum
crosses a quantile. The kernel is `csrc/histogram.cu`; its header says what
bounds it and how it keeps the order.

Indices are read as the reference's `.at[]` reads them: a row in [-A, -1]
counts from the end (A + row), and so does a bucket in [-B, -1]; a sample
whose row is still outside [0, A) is dropped, and one whose row is inside
but whose bucket is not adds to the row's total and to no bin.

The device of the tensors decides: CPU tensors go through
`scatter_add_ordered_plain` (`index_add_`, a sequential loop in sample
order on the CPU), CUDA tensors through the kernel (an atomic
`index_add_` on the card sums in no fixed order; the kernel orders the
samples by row with its own radix passes and folds each row in a warp,
with no library sort), and a tensor the kernel
does not take (dtype, shape, layout, device) raises on either device.
There is no fallback from the kernel to the plain version. Both update the
bank's tensors in place, and neither reads anything back to the host.
"""

from __future__ import annotations

import ctypes
import functools

import torch

SOURCE = "histogram.cu"


def _wrap(idx: torch.Tensor, n: int) -> torch.Tensor:
    """`idx` as `.at[]` reads an index into a dimension of n: one in
    [-n, -1] counts from the end, and one still outside [0, n) becomes n."""
    return torch.where((idx >= -n) & (idx < n), idx.remainder(max(n, 1)), n)


def scatter_add_ordered_plain(weights: torch.Tensor, total: torch.Tensor,
                              agg: torch.Tensor, bucket: torch.Tensor,
                              w: torch.Tensor) -> None:
    """The plain version: `index_add_` of the kept samples, in sample
    order, on the flat bin index `row * n_buckets + bucket` and on `row`.
    On the CPU it adds in sample order, as XLA's CPU scatter does
    (`index_put_(accumulate=True)` does not)."""
    a, n_buckets = weights.shape
    row, bkt = _wrap(agg, a), _wrap(bucket, n_buckets)
    in_row = row < a
    keep = (in_row & (bkt < n_buckets)).nonzero().squeeze(1)
    weights.view(-1).index_add_(
        0, row[keep].long() * n_buckets + bkt[keep].long(), w[keep])
    keep = in_row.nonzero().squeeze(1)
    total.index_add_(0, row[keep].long(), w[keep])


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


TILE = 2048      # csrc/histogram.cu's kTile: samples a sort tile takes
RADIX = 256      # kRadix: the digits a pass's count table keeps


def sort_plan(a: int) -> tuple[int, int]:
    """(passes, bits a digit) of the kernel's radix sort of row keys in
    [0, A]: the keys' bit length in passes of at most 8 bits, as
    csrc/histogram.cu's `plan` splits it."""
    bits = max(a.bit_length(), 1)
    passes = -(-bits // 8)
    return passes, -(-bits // passes)


def workspace_words(n: int, a: int) -> int:
    """The u32 words of workspace a scatter of n samples into an A-row bank
    takes (`ka_hist_workspace` in csrc/histogram.cu): two key and two value
    buffers of n, and the control words (a count a digit a tile a pass,
    each pass's digit totals, each row's end and count)."""
    passes, _ = sort_plan(a)
    tiles = -(-n // TILE)
    return 4 * n + passes * RADIX * tiles + passes * RADIX + 2 * a


@functools.cache
def _entry():
    """The kernel's C entry point, loaded (and built if needed) and typed
    once per process."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels.build import load

    fn = load(SOURCE).ka_hist_scatter
    # every pointer and the stream as c_void_p: ctypes would cut them to int
    fn.argtypes = ([ctypes.c_void_p] * 6
                   + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def scatter_add_ordered(weights: torch.Tensor,  # f32[A, B], updated in place
                        total: torch.Tensor,    # f32[A], updated in place
                        agg: torch.Tensor,      # i32[n] aggregate row
                        bucket: torch.Tensor,   # i32[n] bucket
                        w: torch.Tensor,        # f32[n] sample weight
                        ) -> None:
    """weights[agg[i], bucket[i]] += w[i] and total[agg[i]] += w[i] for
    every sample i, each bin and each total summed in sample order, the
    indices read as `.at[]` reads them (see the module's docstring). CPU
    tensors take the plain version, CUDA tensors the kernel (one call of
    its C entry, counted in `scatter_add_ordered.launches`, and no read to
    the host)."""
    a, b = weights.shape
    n = agg.shape[0]
    dev = weights.device
    _check("weights", weights, torch.float32, (a, b), dev)
    _check("total", total, torch.float32, (a,), dev)
    _check("agg", agg, torch.int32, (n,), dev)
    _check("bucket", bucket, torch.int32, (n,), dev)
    _check("w", w, torch.float32, (n,), dev)
    if n == 0 or a == 0:
        return
    if dev.type == "cpu":
        scatter_add_ordered_plain(weights, total, agg, bucket, w)
        return
    if dev.type != "cuda":
        raise ValueError(f"scatter_add_ordered: no kernel for {dev}")
    with torch.cuda.device(dev):
        launch(weights, total, agg, bucket, w)


def launch(weights, total, agg, bucket, w, order_only: bool = False) -> None:
    """One call of the C entry on checked CUDA tensors: the sort passes and
    the fold, on the current stream, into a workspace allocated here
    (`workspace_words`). `order_only` stops after the sort passes and
    leaves the bank as it is (a timing aid). Counted in
    `scatter_add_ordered.launches`."""
    a, b = weights.shape
    n = agg.shape[0]
    words = workspace_words(n, a)
    ws = torch.empty((words,), dtype=torch.int32, device=weights.device)
    rc = _entry()(
        agg.data_ptr(), bucket.data_ptr(), w.data_ptr(), weights.data_ptr(),
        total.data_ptr(), ws.data_ptr(), words, n, a, b, int(order_only),
        torch.cuda.current_stream(weights.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"histogram scatter launch failed: CUDA error {rc}")
    scatter_add_ordered.launches += 1


scatter_add_ordered.launches = 0

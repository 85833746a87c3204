"""Single-shot device→host fetch for result trees, with bit-packed bools.

Counterpart of the reference package's `ops/hostfetch.py` (`fetch_pytree`
and the round-trip counter). A result tree — the port's frozen dataclasses,
tuples, lists and dicts, with tensors (or numpy arrays) as leaves — comes
home in at most three device→host copies, one per dtype class: every bool
leaf concatenated and bit-packed into int32 words (`bitplane.pack_flat_bits`),
every integer leaf as int32, every float leaf as float32. The host rebuilds
the same structure with each leaf as a numpy array of its original shape and
dtype. Anything in the tree that is not a tensor or an array (an int field,
None) is structure and comes back as it was.

Transfer accounting: pass `phases` (anything with `bump(name, n)`) and every
packed fetch bumps `batched_fetch_bytes_moved` (the bytes of the three
buffers) and `batched_fetch_bytes_logical` (what bool→uint8, int→int32,
float→float32 would have moved).

Round trips: every fetch that reaches the device counts one, unless it runs
inside `suppress_counting()`; `reset_round_trips()` and `round_trips()` read
and clear the count, as the reference's control loop does per loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kubernetes_autoscaler_tpu_torch.ops.bitplane import (
    pack_flat_bits,
    unpack_flat_bits_np,
)

# leaf dtypes the three buffer classes hold without wrapping, and their
# numpy counterparts on the host
_SUPPORTED = {
    torch.bool: np.dtype(np.bool_),
    torch.int8: np.dtype(np.int8),
    torch.int16: np.dtype(np.int16),
    torch.int32: np.dtype(np.int32),
    torch.uint8: np.dtype(np.uint8),
    torch.uint16: np.dtype(np.uint16),
    torch.float32: np.dtype(np.float32),
}

_ROUND_TRIPS = 0
_COUNT_SUPPRESSED = 0


def reset_round_trips() -> None:
    global _ROUND_TRIPS
    _ROUND_TRIPS = 0


def round_trips() -> int:
    return _ROUND_TRIPS


def _bump_round_trip() -> None:
    global _ROUND_TRIPS
    if not _COUNT_SUPPRESSED:
        _ROUND_TRIPS += 1


class suppress_counting:
    """Context manager: fetches inside do not count as loop round trips."""

    def __enter__(self):
        global _COUNT_SUPPRESSED
        _COUNT_SUPPRESSED += 1
        return self

    def __exit__(self, *exc):
        global _COUNT_SUPPRESSED
        _COUNT_SUPPRESSED -= 1
        return False


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _flatten(tree, out: list) -> list:
    """The leaves of `tree` in a fixed order (dict keys sorted)."""
    if _is_leaf(tree):
        out.append(tree)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _flatten(getattr(tree, f.name), out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _flatten(v, out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    return out


def _rebuild(tree, it):
    """`tree` with its leaves replaced, in `_flatten` order, from `it`."""
    if _is_leaf(tree):
        return next(it)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), it)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        vals = [_rebuild(v, it) for v in tree]
        return vals if isinstance(tree, list) else tuple(vals)
    if isinstance(tree, dict):
        vals = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    return tree


def _host_dtype(leaf) -> np.dtype:
    return leaf.dtype if isinstance(leaf, np.ndarray) else _SUPPORTED[leaf.dtype]


def _logical_nbytes(leaves) -> int:
    """Bytes the pre-bit-packing buffer classes would have moved
    (bool→uint8, integer→int32, float→float32)."""
    return sum(_numel(leaf) * (1 if _host_dtype(leaf) == np.bool_ else 4)
               for leaf in leaves)


def _numel(leaf) -> int:
    return leaf.numel() if isinstance(leaf, torch.Tensor) else int(leaf.size)


def _packed(leaves, device):
    """The three buffers (bit words, int32, float32) on `device`."""
    bools, ints, floats = [], [], []
    for leaf in leaves:
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(leaf))
        if t.dtype not in _SUPPORTED:
            # wider types would wrap in the int32/float32 buffers
            raise TypeError(f"fetch_pytree cannot pack dtype {t.dtype}")
        t = t.to(device).reshape(-1)
        if t.dtype == torch.bool:
            bools.append(t)
        elif t.dtype.is_floating_point:
            floats.append(t)
        else:
            ints.append(t.to(torch.int32))

    def cat(parts, dtype):
        if not parts:
            return torch.zeros((0,), dtype=dtype, device=device)
        return torch.cat(parts).to(dtype)

    return (pack_flat_bits(torch.cat(bools)) if bools
            else torch.zeros((0,), dtype=torch.int32, device=device),
            cat(ints, torch.int32), cat(floats, torch.float32))


def _account(phases, bufs, leaves) -> None:
    if phases is None:
        return
    phases.bump("batched_fetch_bytes_moved",
                sum(b.numel() * b.element_size() for b in bufs))
    phases.bump("batched_fetch_bytes_logical", _logical_nbytes(leaves))


def _unflatten(tree, leaves, b_words, i, f):
    """Slice the three host buffers back into the original leaves."""
    n_bool = sum(_numel(leaf) for leaf in leaves
                 if _host_dtype(leaf) == np.bool_)
    b = unpack_flat_bits_np(b_words, n_bool)
    offs = {"b": 0, "i": 0, "f": 0}
    out = []
    for leaf in leaves:
        n = _numel(leaf)
        dt = _host_dtype(leaf)
        if dt == np.bool_:
            chunk, key = b, "b"
        elif np.issubdtype(dt, np.floating):
            chunk, key = f, "f"
        else:
            chunk, key = i, "i"
        out.append(chunk[offs[key]:offs[key] + n]
                   .reshape(tuple(leaf.shape)).astype(dt))
        offs[key] += n
    return _rebuild(tree, iter(out))


def fetch_pytree(tree, phases=None):
    """The same tree with every leaf as a host numpy array of the original
    shape and dtype, in at most three device→host copies (bool leaves ride
    bit-packed). `phases` enables byte accounting."""
    leaves = _flatten(tree, [])
    if leaves and all(isinstance(x, np.ndarray) for x in leaves):
        return tree                  # already on the host: no transfer
    _bump_round_trip()
    if len(leaves) <= 1:
        # one leaf is one copy either way: no packing, no accounting
        return _rebuild(tree, iter(
            [x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x) for x in leaves]))
    device = next(x.device for x in leaves if isinstance(x, torch.Tensor))
    bufs = _packed(leaves, device)
    _account(phases, bufs, leaves)
    b, i, f = (buf.cpu().numpy() for buf in bufs)
    return _unflatten(tree, leaves, b, i, f)

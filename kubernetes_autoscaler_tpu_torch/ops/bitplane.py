"""Bit-packed boolean planes: 32 verdicts per int32 word.

Counterpart of the reference package's `ops/bitplane.py`:

  * `pack_group_bits` / `unpack_group_bits` pack along the group axis,
    `bool[..., G, N] → int32[..., ceil(G/32), N]`, where bit `g % 32` of word
    row `g // 32` is group g's verdict for node lane n. This is the mask
    layout the pack kernels (csrc/pack.cu, csrc/wavefront.cu) read.
  * `pack_flat_bits` (device) / `unpack_flat_bits_np` (host) pack a flat
    bool stream; ops/hostfetch moves bool leaves this way, one bit each.

Packing is little-endian within a word and round-trips bit for bit; words
are int32, so bit 31 is the sign bit.
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32


def words_for(n: int) -> int:
    """How many int32 words hold `n` bits."""
    return (n + WORD_BITS - 1) // WORD_BITS


def pack_group_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool[..., G, N] → int32[..., ceil(G/32), N], packed along axis -2.

    Padding rows are zero (infeasible). The reference shifts and sums in
    int32. Here each bit is shifted to its place in int64 and the 32 places
    of a word are summed: they are distinct powers of two, so the sum is
    their bitwise OR and lies in [0, 2^32). Narrowing to int32 then wraps
    bit 31 onto the sign bit exactly as the reference's int32 sum does.
    (One shift and one sum, where an OR loop would launch 64 kernels.)"""
    m = mask.to(torch.bool)
    g, n = m.shape[-2], m.shape[-1]
    gw = words_for(g)
    pad = gw * WORD_BITS - g
    if pad:
        m = torch.cat([m, m.new_zeros((*m.shape[:-2], pad, n))], dim=-2)
    m = m.reshape(*m.shape[:-2], gw, WORD_BITS, n)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=m.device)
    words = (m.to(torch.int64) << shifts[:, None]).sum(dim=-2)
    return words.to(torch.int32)


def unpack_group_bits(words: torch.Tensor, g: int) -> torch.Tensor:
    """Inverse of pack_group_bits: int32[..., Gw, N] → bool[..., G, N]."""
    w = words.to(torch.int64) & 0xFFFFFFFF        # logical view of the word
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=w.device)
    bits = (w[..., :, None, :] >> shifts[:, None]) & 1
    full = bits.reshape(*w.shape[:-2], w.shape[-2] * WORD_BITS, w.shape[-1])
    return full[..., :g, :].to(torch.bool)


def pack_flat_bits(flat: torch.Tensor) -> torch.Tensor:
    """bool[n] → int32[ceil(n/32)] little-endian bit stream (at least one
    word, as the reference). Bit 31 wraps onto the sign bit as in
    `pack_group_bits`."""
    m = flat.to(torch.bool).reshape(-1)
    n = m.shape[0]
    nw = words_for(max(n, 1))
    pad = nw * WORD_BITS - n
    if pad:
        m = torch.cat([m, m.new_zeros((pad,))])
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=m.device)
    words = (m.reshape(nw, WORD_BITS).to(torch.int64) << shifts).sum(dim=1)
    return words.to(torch.int32)


def unpack_flat_bits_np(words: np.ndarray, n: int) -> np.ndarray:
    """Host inverse of pack_flat_bits: int32 words → bool[n]."""
    w = np.asarray(words).astype(np.uint32)
    if n == 0:
        return np.zeros((0,), bool)
    bits = (w[:, None] >> np.arange(WORD_BITS, dtype=np.uint32)[None, :]) & 1
    return bits.reshape(-1)[:n].astype(bool)

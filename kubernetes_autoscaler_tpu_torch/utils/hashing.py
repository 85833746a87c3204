"""Deterministic 64-bit hashing and bloom-mask encoding.

The reference operates on strings (labels, taints, selectors) via Go map lookups
per pod×node pair (vendored kube-scheduler plugins, e.g. TaintToleration / NodeAffinity
filters invoked from plugin_runner.go:146). The TPU plane cannot chase strings, so the
string world is lowered once on the host into fixed-width bloom bitmasks and the
per-pair checks become bitwise superset tests (see ops/predicates.py).

Bloom membership is probabilistic; the framework's contract (mirroring the reference's
own split between simulated scheduling and real kubelet admission) is:
  * the dense pods×nodes fast path may produce rare false "fits" (never false "does
    not fit" for the subset-encoded predicates — a missing required bit always rejects),
  * every *selected* assignment is re-verified exactly on the host before actuation
    (core/scaleup/orchestrator.py), so no incorrect action is ever taken.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1a64(data: str | bytes) -> int:
    """Stable FNV-1a 64-bit hash (process-independent, unlike Python's hash())."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


@lru_cache(maxsize=1 << 18)
def fold32(data: str | bytes) -> int:
    """64-bit FNV-1a folded to a nonzero signed int32 (0 is the padding sentinel).

    TPUs run with 32-bit integers (JAX x64 disabled); a 32-bit hash over the
    few-thousand distinct strings of one cluster snapshot collides with
    probability ~1e-3 per snapshot, and any collision can only *relax* a
    predicate — the host-side winner verification (exact string semantics)
    catches it before actuation.

    Memoized: snapshot encoding re-hashes the same label/taint strings for
    every node row (5k nodes × ~dozens of strings per loop, heavily repeated)
    — the cache turns the per-byte Python FNV loop into a dict hit.
    """
    h = fnv1a64(data)
    h32 = (h ^ (h >> 32)) & 0xFFFFFFFF
    if h32 == 0:
        h32 = 1
    if h32 >= 1 << 31:
        h32 -= 1 << 32
    return h32


# Bloom geometry: BLOOM_WORDS uint32 words, K bit positions per element.
BLOOM_WORDS = 8          # 256 bits
BLOOM_BITS = BLOOM_WORDS * 32
BLOOM_K = 2


def bloom_bit_positions(item: str, nbits: int = BLOOM_BITS, k: int = BLOOM_K) -> list[int]:
    """Double-hashing scheme: positions h1 + i*h2 mod nbits."""
    h = fnv1a64(item)
    h1 = h & 0xFFFFFFFF
    h2 = (h >> 32) | 1  # odd => full-period stepping
    return [(h1 + i * h2) % nbits for i in range(k)]


def bloom_insert(words: np.ndarray, item: str) -> None:
    """Set the bits for `item` in a uint32[BLOOM_WORDS] array, in place."""
    for pos in bloom_bit_positions(item, nbits=words.shape[-1] * 32):
        words[pos // 32] |= np.uint32(1 << (pos % 32))


def bloom_from_items(items, nwords: int = BLOOM_WORDS) -> np.ndarray:
    words = np.zeros((nwords,), dtype=np.uint32)
    for it in items:
        bloom_insert(words, it)
    return words


def bloom_might_contain(words: np.ndarray, item: str) -> bool:
    for pos in bloom_bit_positions(item, nbits=words.shape[-1] * 32):
        if not (int(words[pos // 32]) >> (pos % 32)) & 1:
            return False
    return True


def bloom_is_superset(sup: np.ndarray, sub: np.ndarray) -> bool:
    """True iff every bit of `sub` is set in `sup` (host-side mirror of the device test)."""
    return bool(np.all((sup & sub) == sub))

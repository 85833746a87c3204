"""Deterministic string hashing for the dense encoding.

Copy of the reference package's `utils/hashing.fold32`: label, taint,
selector and port planes are int32 hash slots, so the port's hashes must be
bit-identical to the reference's for the two encoders to agree.
"""

from __future__ import annotations

from functools import lru_cache

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

    A collision can only relax a predicate; the host-side winner check
    catches it before actuation. Memoized: one snapshot re-hashes the same
    label and taint strings for every node row."""
    h = fnv1a64(data)
    h32 = (h ^ (h >> 32)) & 0xFFFFFFFF
    if h32 == 0:
        h32 = 1
    if h32 >= 1 << 31:
        h32 -= 1 << 32
    return h32

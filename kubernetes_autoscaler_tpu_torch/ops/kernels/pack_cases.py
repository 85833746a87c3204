"""Seeded inputs for K1 (`pack_kernel.pack_groups_batched`): the cases that
`chip_smoke.py` and `tests/test_torch_kernels_cuda.py` hold byte-equal to
the plain version on the card.

`CASES` maps each case's name to a builder; a builder returns
[free, mask, req, count, order, limit_one] on the CPU. Besides the shapes
of the main path, the cases reach every branch of `csrc/pack.cu`: dead
groups, negative counts, zero requests, mask bit 31, the division-free
fit's edges, and each placement of the free plane and the mask (shared or
device memory) with one chunk and with several.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_autoscaler_tpu_torch.ops.pack import ffd_order

BIG = 2 ** 31 - 1


def pack_case(seed, b, g, n, r=8, max_count=3000, zero_req=True,
              limit_share=0.2, mask_p=0.8):
    """[free, mask, req, count, order, limit_one], seeded, on the CPU; group
    0 requests nothing unless `zero_req` is false."""
    rng = np.random.default_rng(seed)
    free = torch.from_numpy(rng.integers(0, 40, size=(b, n, r)).astype(np.int32))
    req = torch.from_numpy(rng.integers(0, 6, size=(g, r)).astype(np.int32))
    if zero_req:
        req[0] = 0
    count = torch.from_numpy(rng.integers(0, max_count, size=(g,)).astype(np.int32))
    mask = torch.from_numpy(rng.random((b, g, n)) < mask_p)
    limit_one = torch.from_numpy(rng.random((g,)) < limit_share)
    order = ffd_order(req, torch.ones((g,), dtype=torch.bool))
    return [free, mask, req, count, order, limit_one]


def _zero_requests():
    a = pack_case(4, 2, 3, 200)
    a[0].zero_()
    a[2].zero_()
    a[3] = torch.tensor([7, 0, 2 ** 30], dtype=torch.int32)
    return a


def _bit31():
    a = pack_case(6, 2, 32, 300)
    a[1].zero_()
    a[1][:, 31, :] = True
    return a


def _dead_interleaved():
    a = pack_case(11, 2, 40, 700)
    a[3][::4] = 0                                  # count 0
    a[1][:, 1::4, :] = False                       # empty mask
    a[1][:, 2::4, :] = False                       # both
    a[3][2::4] = 0
    return a


def _all_dead():
    a = pack_case(12, 2, 20, 300)
    a[3][::2] = 0
    a[1][:, 1::2, :] = False
    return a


def _negative():
    a = pack_case(13, 2, 24, 500)
    a[3][::3] = -a[3][::3] - 1                     # the formula's result
    a[1][:, 3, :] = False
    a[3][3] = -5                                   # negative, empty mask
    return a


def _divisors():
    """Requests 1, 2, 3, 7, powers of two and values near 2^31-1 against
    free values near 2^31-1, counts up to 2^31-1."""
    a = pack_case(14, 2, 16, 300, max_count=BIG, mask_p=0.9)
    a[2] = torch.tensor([[1, 2, 3, 7, 4, 8, 1024, BIG],
                         [BIG, BIG - 1, 2 ** 30, 3, 0, 0, 0, 1]] * 8,
                        dtype=torch.int32)
    a[0][:, ::2, :] = BIG
    a[0][:, 1::3, :] = BIG - 1
    a[0][:, 5::7, 2] = 2 ** 30 + 7
    return a


CASES = {
    **{f"option shape B=24 G=64 N=1024, seed {s}":
       (lambda s=s: pack_case(s, 24, 64, 1024)) for s in range(3)},
    "filter shape B=1 G=64 N=5120": lambda: pack_case(3, 1, 64, 5120),
    "zero-request groups on empty nodes": _zero_requests,
    "limit_one groups": lambda: pack_case(5, 4, 16, 700, limit_share=1.0),
    "only group 31 (the sign bit) feasible": _bit31,
    "G=33 (two mask words)": lambda: pack_case(7, 3, 33, 512),
    "N=1031, not a multiple of the block": lambda: pack_case(8, 2, 12, 1031),
    "N=40, less than one warp per lane": lambda: pack_case(9, 1, 5, 40),
    "interleaved dead groups: count 0, empty mask, both": _dead_interleaved,
    "every group dead": _all_dead,
    "negative counts, one with an empty mask": _negative,
    "divisor and free-value edges": _divisors,
    "N=4100: a short last warp": lambda: pack_case(17, 3, 30, 4100),
    "N=6000: free plane in shared memory, mask in device memory":
        lambda: pack_case(15, 2, 64, 6000),
    "N=8192: free plane in device memory": lambda: pack_case(10, 2, 40, 8192),
    "N=16384, R=2: both in shared memory, two chunks":
        lambda: pack_case(18, 1, 20, 16384, r=2),
    "N=20000, R=2: free plane in shared memory, three chunks":
        lambda: pack_case(19, 1, 40, 20000, r=2),
    "N=20000: free plane in device memory, three chunks":
        lambda: pack_case(20, 1, 40, 20000),
    "N=70000: both in device memory, nine chunks":
        lambda: pack_case(16, 1, 20, 70000),
}

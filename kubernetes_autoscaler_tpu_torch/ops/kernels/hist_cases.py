"""Seeded inputs for the VPA histogram scatter
(`histogram_kernel.scatter_add_ordered`): the cases that `chip_smoke.py`
and `tests/test_torch_kernels_cuda.py` hold byte-equal to the plain version
on the card, and that the CPU tests hold to a sequential sum in sample
order.

`CASES` maps each case's name to a builder; a builder returns
[weights, total, agg, bucket, w] on the CPU. Besides the shapes of the
recommender's feeds (a RunOnce's 100,000 samples over 20,000 aggregates, a
history of 192 samples an aggregate), the cases reach a skewed batch (one
aggregate owning most samples), runs of one sample, bins that already hold
weight, weights over many binades and a single sample, and the edges of the
kernel's design: a bank past 65,536 rows (a row key of 17 bits, three sort
passes), rows in descending sample order (the sort's stability), every
sample dropped, one row holding a batch several sort tiles long, and n one
past a tile boundary.

`OUT_OF_BANK` lists (row, bucket) pairs outside a bank of OOB_ROWS x
OOB_BUCKETS or counted from its end, and `out_of_bank_case` puts one of
them among seeded samples: the reference's `.at[]` wraps a negative index
once and drops a row still outside the bank, or only the bin when the row
is inside (tests/test_torch_vpa.py holds the plain version to it).
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_autoscaler_tpu_torch.ops.kernels.histogram_kernel import TILE

N_BUCKETS = 176


def hist_case(seed, n_agg, n, rows=None, bins=N_BUCKETS, skew=0.0,
              start_density=0.3, w_sigma=2.0):
    """[weights, total, agg, bucket, w], seeded, on the CPU: n samples over
    `rows` aggregates (default all of them) of an n_agg-row bank whose bins
    start with weight at `start_density`; a `skew` share of the samples
    goes to aggregate 0."""
    rng = np.random.default_rng(seed)
    weights = (rng.lognormal(0, 1, (n_agg, bins))
               * (rng.random((n_agg, bins)) < start_density)).astype(np.float32)
    total = weights.sum(-1, dtype=np.float32)
    agg = rng.integers(0, rows or n_agg, n).astype(np.int32)
    agg[rng.random(n) < skew] = 0
    bucket = np.clip(rng.normal(bins / 2, bins / 8, n), 0,
                     bins - 1).astype(np.int32)
    w = rng.lognormal(0, w_sigma, n).astype(np.float32)
    return [torch.from_numpy(x) for x in (weights, total, agg, bucket, w)]


def _one_sample():
    return hist_case(1, 4, 1)


def _one_bin():
    a = hist_case(2, 3, 5000)
    a[2].fill_(1)
    a[3].fill_(7)
    return a


def history_case(n_agg=2000, per=192, bank=3380, seed=3):
    """`per` samples for each of n_agg aggregates, hourly, in series order
    (each aggregate's samples together), into a grown bank of `bank` rows
    that starts empty. The recommender's history feed is 20,000 x 192 into
    33,790 rows."""
    rng = np.random.default_rng(seed)
    a = hist_case(seed, bank, n_agg * per, rows=n_agg, start_density=0.0)
    a[2] = torch.from_numpy(np.repeat(np.arange(n_agg, dtype=np.int32), per))
    a[4] = torch.from_numpy(
        (rng.lognormal(-1, 1, n_agg * per)
         * 2.0 ** (-np.tile(np.arange(per)[::-1], n_agg) / 24.0)
         ).astype(np.float32))
    return a


def _wide_bank():
    """A bank of 70,000 rows (a row key of 17 bits: three sort passes of 6
    bits), narrow bins."""
    return hist_case(10, 70_000, 30_000, bins=8)


def _descending_rows():
    """Rows in descending sample order, 20 samples a row over 4 bins: the
    sort reverses the rows, and every bin's adds must keep sample order."""
    a = hist_case(11, 300, 6000, bins=4, w_sigma=6.0)
    a[2] = torch.from_numpy(np.repeat(np.arange(300, dtype=np.int32)[::-1],
                                      20))
    a[3] = torch.from_numpy(np.tile(np.arange(4, dtype=np.int32), 1500))
    return a


def _all_dropped():
    """Every sample's row outside the bank (past its end, or before its
    start counted from the end): nothing changes."""
    a = hist_case(12, 50, 3000)
    rng = np.random.default_rng(12)
    a[2] = torch.from_numpy(np.where(rng.random(3000) < 0.5,
                                     rng.integers(50, 200, 3000),
                                     rng.integers(-200, -50, 3000))
                            .astype(np.int32))
    return a


def _one_row_many_tiles():
    """One row holding every sample of a batch five sort tiles and more
    long (10,247 samples), over a few bins."""
    a = hist_case(13, 10, 5 * TILE + 7, bins=6, w_sigma=4.0)
    a[2].fill_(3)
    return a


CASES = {
    "run_once": lambda: hist_case(0, 33790, 100_000, rows=20_000),
    "history": history_case,
    "skewed": lambda: hist_case(4, 500, 60_000, skew=0.9),
    "sparse_runs": lambda: hist_case(5, 50_000, 30_000),
    "wide_weights": lambda: hist_case(6, 64, 20_000, w_sigma=8.0),
    "one_sample": _one_sample,
    "one_bin": _one_bin,
    "wide_bank": _wide_bank,
    "descending_rows": _descending_rows,
    "all_dropped": _all_dropped,
    "one_row_many_tiles": _one_row_many_tiles,
    "tile_edge": lambda: hist_case(14, 40, 2 * TILE + 1),
}


OOB_ROWS, OOB_BUCKETS = 4, 6
OUT_OF_BANK = (
    (-1, 2),                 # row -1: row A - 1
    (-OOB_ROWS, 2),          # row -A: row 0
    (-OOB_ROWS - 1, 2),      # dropped
    (OOB_ROWS, 2),           # dropped
    (1, -1),                 # bucket B - 1
    (1, -OOB_BUCKETS - 1),   # the total only
    (1, OOB_BUCKETS),        # the total only
    (1, -OOB_BUCKETS),       # bucket 0
    (-OOB_ROWS - 1, -OOB_BUCKETS - 1),   # dropped
)


def out_of_bank_case(row, bucket, n=100):
    """[weights, total, agg, bucket, w] of n seeded samples on an
    OOB_ROWS x OOB_BUCKETS bank, sample n // 3 at (row, bucket); n = 1 is
    that sample alone on an empty bank."""
    if n == 1:
        a = hist_case(1, OOB_ROWS, 1, bins=OOB_BUCKETS, start_density=0.0)
        a[4].fill_(1.0)
    else:
        a = hist_case(9, OOB_ROWS, n, bins=OOB_BUCKETS)
    a[2][n // 3] = row
    a[3][n // 3] = bucket
    return a

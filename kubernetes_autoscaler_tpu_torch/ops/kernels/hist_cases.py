"""Seeded inputs for the VPA histogram scatter
(`histogram_kernel.scatter_add_ordered`): the cases that `chip_smoke.py`
and `tests/test_torch_kernels_cuda.py` hold byte-equal to the plain version
on the card, and that the CPU tests hold to a sequential sum in sample
order.

`CASES` maps each case's name to a builder; a builder returns
[weights, total, agg, bucket, w] on the CPU. Besides the shapes of the
recommender's feeds (a RunOnce's 100,000 samples over 20,000 aggregates, a
history of 192 samples an aggregate), the cases reach a run that spans many
thread blocks (one aggregate owning most samples), runs of one sample,
bins that already hold weight, weights over many binades and a single
sample.
"""

from __future__ import annotations

import numpy as np
import torch

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


def _history():
    """192 samples for each of 2,000 aggregates, hourly, in series order
    (each aggregate's samples together), into a grown bank."""
    rng = np.random.default_rng(3)
    n_agg, per = 2000, 192
    a = hist_case(3, 3380, n_agg * per, rows=n_agg, start_density=0.0)
    a[2] = torch.from_numpy(np.repeat(np.arange(n_agg, dtype=np.int32), per))
    a[4] = torch.from_numpy(
        (rng.lognormal(-1, 1, n_agg * per)
         * 2.0 ** (-np.tile(np.arange(per)[::-1], n_agg) / 24.0)
         ).astype(np.float32))
    return a


CASES = {
    "run_once": lambda: hist_case(0, 33790, 100_000, rows=20_000),
    "history": _history,
    "skewed": lambda: hist_case(4, 500, 60_000, skew=0.9),
    "sparse_runs": lambda: hist_case(5, 50_000, 30_000),
    "wide_weights": lambda: hist_case(6, 64, 20_000, w_sigma=8.0),
    "one_sample": _one_sample,
    "one_bin": _one_bin,
}

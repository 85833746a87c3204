"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed: `python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py`.
Without a CUDA device every test skips. Tolerance: none (integer outputs).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_autoscaler_tpu_torch.ops import pack
from kubernetes_autoscaler_tpu_torch.ops.kernels import (
    pack_cases,
    pack_kernel,
    wavefront_kernel,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,n", [(1, 5, 40), (3, 33, 1031), (20, 64, 1024),
                                   (1, 64, 5120), (2, 40, 8192)])
def test_pack_kernel_matches_plain(cuda, b, g, n):
    args = pack_cases.pack_case(b * 1000 + n, b, g, n)
    want = pack_kernel.pack_groups_batched_plain(*args)
    before = pack_kernel.pack_groups_batched.launches
    got = pack_kernel.pack_groups_batched(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert pack_kernel.pack_groups_batched.launches == before + 1
    for name in ("placed", "scheduled", "free_after"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(pack_cases.CASES))
def test_pack_kernel_edge_cases(cuda, name):
    args = pack_cases.CASES[name]()
    want = pack_kernel.pack_groups_batched_plain(*args)
    got = pack_kernel.pack_groups_batched(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    for field in ("placed", "scheduled", "free_after"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field


@pytest.mark.cuda
def test_pack_kernel_rejects_what_it_does_not_take(cuda):
    free, mask, req, count, order, limit_one = [
        a.to(cuda) for a in pack_cases.pack_case(0, 2, 4, 64)]
    with pytest.raises(TypeError):
        pack_kernel.pack_groups_batched(free.long(), mask, req, count, order,
                                        limit_one)
    with pytest.raises(ValueError):
        pack_kernel.pack_groups_batched(free.transpose(1, 2).contiguous()
                                        .transpose(1, 2), mask, req, count,
                                        order, limit_one)
    with pytest.raises(ValueError):
        pack_kernel.pack_groups_batched(free, mask.cpu(), req, count, order,
                                        limit_one)


def _wave_instance(seed, g, n, r=8, style="mixed", max_count=3000):
    """(free, mask, req, count, limit_one, waves) with the plan built from
    the mask, in the three mask styles of tests/test_wavefront_pack.py."""
    rng = np.random.default_rng(seed)
    free = rng.integers(0, 40, size=(n, r)).astype(np.int32)
    req = rng.integers(0, 6, size=(g, r)).astype(np.int32)
    req[0] = 0                                     # a zero-request group
    count = rng.integers(0, max_count, size=(g,)).astype(np.int32)
    mask = np.zeros((g, n), bool)
    for gi in range(g):
        if style == "overlap" or (style == "mixed" and gi % 3 == 0):
            mask[gi] = rng.random(n) < 0.6
        elif style == "disjoint" or (style == "mixed" and gi % 3 == 1):
            blk = gi % 4
            mask[gi, blk * (n // 4):(blk + 1) * (n // 4)] = True
        else:
            mask[gi] = rng.random(n) < 0.2
    limit_one = rng.random(g) < 0.3
    order = pack.ffd_order(torch.from_numpy(req), torch.ones((g,), dtype=torch.bool))
    waves = pack.build_wavefront_plan(mask, order.numpy(), device="cpu").waves
    return (torch.from_numpy(free), torch.from_numpy(mask), torch.from_numpy(req),
            torch.from_numpy(count), torch.from_numpy(limit_one), waves)


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,style", [(5, 40, "mixed"), (33, 1031, "mixed"),
                                       (24, 2000, "negative"),
                                       (64, 5120, "disjoint"), (64, 5120, "overlap"),
                                       (40, 8192, "mixed")])
def test_wavefront_kernel_matches_plain(cuda, g, n, style):
    args = _wave_instance(g * 1000 + n, g, n,
                          style="disjoint" if style == "negative" else style)
    if style == "negative":                        # the formula's result
        args[3][::3] = -args[3][::3] - 1
    want = wavefront_kernel.pack_groups_wavefront_plain(*args)
    before = wavefront_kernel.pack_groups_wavefront.launches
    got = wavefront_kernel.pack_groups_wavefront(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert wavefront_kernel.pack_groups_wavefront.launches == before + 1
    for name in ("placed", "scheduled", "free_after"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


@pytest.mark.cuda
def test_wavefront_kernel_one_wave_with_more_slots_than_warps(cuda):
    free, mask, req, count, limit_one, _ = _wave_instance(7, 64, 4096)
    mask.zero_()
    for gi in range(64):                           # a perfect partition
        mask[gi, gi * 64:(gi + 1) * 64] = True
    waves = pack.build_wavefront_plan(mask.numpy(), np.arange(64),
                                      device="cpu").waves
    assert tuple(waves.shape) == (4, 64)
    args = (free, mask, req, count, limit_one, waves)
    want = wavefront_kernel.pack_groups_wavefront_plain(*args)
    got = wavefront_kernel.pack_groups_wavefront(*[a.to(cuda) for a in args])
    for name in ("placed", "scheduled", "free_after"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


@pytest.mark.cuda
def test_wavefront_kernel_rejects_what_it_does_not_take(cuda):
    free, mask, req, count, limit_one, waves = [
        a.to(cuda) for a in _wave_instance(0, 6, 64)]
    bad = waves.clone()
    bad[0, 0] = 6                                  # G = 6: out of range
    with pytest.raises(ValueError, match="group ids"):
        wavefront_kernel.pack_groups_wavefront(free, mask, req, count,
                                               limit_one, bad)
    with pytest.raises(ValueError, match="contiguous"):
        wavefront_kernel.pack_groups_wavefront(free, mask.T.contiguous().T, req,
                                               count, limit_one, waves)
    with pytest.raises(ValueError):
        wavefront_kernel.pack_groups_wavefront(free, mask, req, count,
                                               limit_one, waves.cpu())
    checked = waves.clone()
    wavefront_kernel.pack_groups_wavefront(free, mask, req, count, limit_one,
                                           checked)
    checked[0, 0] = 6                              # an in-place edit is read again
    with pytest.raises(ValueError, match="group ids"):
        wavefront_kernel.pack_groups_wavefront(free, mask, req, count,
                                               limit_one, checked)

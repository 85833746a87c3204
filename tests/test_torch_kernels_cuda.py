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
from kubernetes_autoscaler_tpu_torch.ops.kernels import pack_kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _instance(seed, b, g, n, r=8, max_count=3000):
    rng = np.random.default_rng(seed)
    free = torch.from_numpy(rng.integers(0, 40, size=(b, n, r)).astype(np.int32))
    req = torch.from_numpy(rng.integers(0, 6, size=(g, r)).astype(np.int32))
    req[0] = 0                                     # a zero-request group
    count = torch.from_numpy(rng.integers(0, max_count, size=(g,)).astype(np.int32))
    mask = torch.from_numpy(rng.random((b, g, n)) < 0.8)
    limit_one = torch.from_numpy(rng.random((g,)) < 0.2)
    order = pack.ffd_order(req, torch.ones((g,), dtype=torch.bool))
    return free, mask, req, count, order, limit_one


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,n", [(1, 5, 40), (3, 33, 1031), (20, 64, 1024),
                                   (1, 64, 5120), (2, 40, 8192)])
def test_pack_kernel_matches_plain(cuda, b, g, n):
    args = _instance(b * 1000 + n, b, g, n)
    want = pack_kernel.pack_groups_batched_plain(*args)
    before = pack_kernel.pack_groups_batched.launches
    got = pack_kernel.pack_groups_batched(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert pack_kernel.pack_groups_batched.launches == before + 1
    for name in ("placed", "scheduled", "free_after"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


@pytest.mark.cuda
def test_pack_kernel_rejects_what_it_does_not_take(cuda):
    free, mask, req, count, order, limit_one = [
        a.to(cuda) for a in _instance(0, 2, 4, 64)]
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

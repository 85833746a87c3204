"""First-fit packing primitive: place pod equivalence groups onto node bins.

Counterpart of the reference package's `ops/pack.py` (PackResult, fit_count,
pack_groups, ffd_order). A whole equivalence group is placed in one step:
per node, how many exemplars still fit is an integer divide over the free
vector, and first-fit order is a prefix sum over nodes in index order. The
groups go one after another in FFD order, carrying the free capacity.

`pack_groups` is the batch-of-one call of the hand-written pack kernel
(ops/kernels/pack_kernel.py); the tensor's device picks the kernel (CUDA)
or its plain version (CPU).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import _Tree

BIG = 1 << 30


@dataclass(frozen=True)
class PackResult(_Tree):
    free_after: torch.Tensor   # i32[..., N, R] remaining capacity after placement
    placed: torch.Tensor       # i32[..., G, N] pods of group g placed on node n
    scheduled: torch.Tensor    # i32[..., G] total pods placed per group (≤ count)


def fit_count(free: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """i32[..., N]: how many pods with request vector `req` (i32[..., R],
    broadcast over the node axis) fit into the `free` rows (i32[..., N, R]).

    Resource slots with req==0 impose no constraint. Negative free → 0."""
    req = req.unsqueeze(-2)
    per_r = torch.where(req > 0, free.clamp(min=0) // req.clamp(min=1), BIG)
    return per_r.amin(dim=-1)


def pack_groups(
    free: torch.Tensor,       # i32[N, R]
    mask: torch.Tensor,       # bool[G, N] placement-independent feasibility
    req: torch.Tensor,        # i32[G, R]
    count: torch.Tensor,      # i32[G] pods wanted per group
    order: torch.Tensor,      # i32[G] permutation: group processing order
    limit_one: torch.Tensor,  # bool[G] cap placement at 1/node
) -> PackResult:
    """First-fit-decreasing placement of all groups onto the node bins."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels.pack_kernel import (
        pack_groups_batched,
    )

    res = pack_groups_batched(free[None].contiguous(), mask[None].contiguous(),
                              req, count, order, limit_one)
    return PackResult(free_after=res.free_after[0], placed=res.placed[0],
                      scheduled=res.scheduled[0])


def ffd_order(req: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Decreasing-size group order over a float32 cpu+memory score; invalid
    rows sort last. The sort is stable, as the reference's `jnp.argsort`,
    so groups with equal scores keep their index order."""
    score = (req[:, 0].to(torch.float32)
             + req[:, 1].to(torch.float32) / 1024.0)
    score = torch.where(valid, score, -1.0)
    return torch.argsort(-score, stable=True).to(torch.int32)

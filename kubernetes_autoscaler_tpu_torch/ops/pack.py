"""First-fit packing primitive: place pod equivalence groups onto node bins.

Counterpart of the reference package's `ops/pack.py` (PackResult, fit_count,
pack_groups, ffd_order). A whole equivalence group is placed in one step:
per node, how many exemplars still fit is an integer divide over the free
vector, and first-fit order is a prefix sum over nodes in index order. The
groups go one after another in FFD order, carrying the free capacity.

`pack_groups` is the batch-of-one call of the hand-written pack kernel
(ops/kernels/pack_kernel.py); the tensor's device picks the kernel (CUDA)
or its plain version (CPU).

Wavefront packing (counterpart of the reference's WavefrontPlan,
compute_wavefronts, build_wavefront_plan, WavefrontCache and
pack_groups_wavefront): a host-side coloring of the groups' mask-overlap
graph batches the serial group scan into W waves of groups whose masks are
disjoint, and `pack_groups_wavefront` places a whole wave per step
(ops/kernels/wavefront_kernel.py: the kernel on CUDA tensors, its plain
version on CPU tensors).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
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


@dataclass(frozen=True)
class WavefrontPlan(_Tree):
    """Conflict-free batching of the group scan into W wavefronts.

    `waves[w]` holds the group ids placed in step w (-1 = padding). Within
    one wave all pairwise feasibility masks are disjoint, so placements
    commute; across waves every conflicting pair keeps its first-fit order
    (see compute_wavefronts)."""

    waves: torch.Tensor   # i32[W, S] group ids per wavefront, -1-padded
    n_waves: int = 0      # real W (before padding)
    n_active: int = 0     # groups colored

    @property
    def worthwhile(self) -> bool:
        """True when batching shortens the scan (W < active groups)."""
        return self.n_waves < self.n_active


def compute_wavefronts(mask: np.ndarray, order: np.ndarray,
                       active: np.ndarray | None = None) -> list[list[int]]:
    """Precedence-respecting coloring of the mask-overlap graph (host).

    layer(g) = 1 + max(layer(h)) over groups h EARLIER in `order` whose masks
    intersect g's: within a layer masks are pairwise disjoint, and across
    layers every conflicting pair keeps its `order` sequence, so the wave
    pack equals the serial scan. Groups that cannot place anything
    (`active` false, or an empty mask) go to wave 0 and stay out of the
    conflict graph."""
    mask = np.asarray(mask, bool)
    order = np.asarray(order)
    g = mask.shape[0]
    if active is None:
        active = mask.any(axis=1)
    else:
        active = np.asarray(active, bool) & mask.any(axis=1)
    conflict = (mask.astype(np.int32) @ mask.astype(np.int32).T) > 0
    layer = np.zeros((g,), np.int64)
    seen: list[int] = []
    for gi in order.tolist():
        if not active[gi]:
            continue
        prev = [h for h in seen if conflict[gi, h]]
        layer[gi] = (max(layer[h] for h in prev) + 1) if prev else 0
        seen.append(gi)
    n_waves = int(layer[seen].max()) + 1 if seen else 1
    waves: list[list[int]] = [[] for _ in range(n_waves)]
    for gi in order.tolist():          # order position within each wave
        if active[gi]:
            waves[int(layer[gi])].append(int(gi))
        else:
            waves[0].append(int(gi))   # dead group: zero placement, any step
    return waves


def build_wavefront_plan(mask: np.ndarray, order: np.ndarray,
                         active: np.ndarray | None = None,
                         pad_w: int = 4, pad_s: int = 8,
                         device: str | torch.device | None = None
                         ) -> WavefrontPlan:
    """compute_wavefronts, padded to shape buckets of `pad_w` waves and
    `pad_s` slots; `waves` goes to `device` (None = CUDA)."""
    from kubernetes_autoscaler_tpu_torch.device import resolve_device

    waves = compute_wavefronts(mask, order, active=active)
    w = len(waves)
    s = max(max((len(wv) for wv in waves), default=1), 1)
    w_pad = ((w + pad_w - 1) // pad_w) * pad_w
    s_pad = ((s + pad_s - 1) // pad_s) * pad_s
    arr = np.full((w_pad, s_pad), -1, np.int32)
    for i, wv in enumerate(waves):
        arr[i, : len(wv)] = wv
    n_active = int(np.asarray(mask, bool).any(axis=1).sum()) \
        if active is None else int(np.count_nonzero(active))
    return WavefrontPlan(waves=torch.from_numpy(arr).to(resolve_device(device)),
                         n_waves=w, n_active=max(n_active, 1))


class WavefrontCache:
    """Single-entry plan cache keyed by a byte fingerprint of (mask, order,
    active) — bit-packed, so the retained key is G×N/8 bytes — and the
    device. Count-only churn between control loops is a hit; composition
    churn is a miss. `phases` (anything with `bump(name, n)`) gets
    `wavefront_cache_hit` / `wavefront_cache_miss`."""

    def __init__(self, pad_w: int = 4, pad_s: int = 8):
        self._entry: tuple | None = None
        self.pad_w = pad_w
        self.pad_s = pad_s
        self.hits = 0
        self.misses = 0

    def plan(self, mask: np.ndarray, order: np.ndarray,
             active: np.ndarray | None = None, phases=None,
             device: str | torch.device | None = None) -> WavefrontPlan:
        mask = np.asarray(mask, bool)
        order = np.asarray(order)
        act = None if active is None else np.asarray(active, bool)
        fp = (mask.shape, np.packbits(mask).tobytes(), order.tobytes(),
              None if act is None else np.packbits(act).tobytes(),
              str(device))
        if self._entry is not None and self._entry[0] == fp:
            self.hits += 1
            if phases is not None:
                phases.bump("wavefront_cache_hit")
            return self._entry[1]
        self.misses += 1
        if phases is not None:
            phases.bump("wavefront_cache_miss")
        plan = build_wavefront_plan(mask, order, active=act, pad_w=self.pad_w,
                                    pad_s=self.pad_s, device=device)
        self._entry = (fp, plan)
        return plan


def pack_groups_wavefront(
    free: torch.Tensor,       # i32[N, R]
    mask: torch.Tensor,       # bool[G, N]
    req: torch.Tensor,        # i32[G, R]
    count: torch.Tensor,      # i32[G]
    limit_one: torch.Tensor,  # bool[G]
    plan: WavefrontPlan,
) -> PackResult:
    """First-fit pack with the group scan batched into the plan's waves:
    every slot of a wave places against the wave-start free capacity and
    the slots' placements are subtracted once per wave, so the serial depth
    is W, not G. Equal to `pack_groups(free, mask, req, count, order,
    limit_one)` when `plan` was built from (a superset of) `mask` in the
    same `order`: a superset only adds conflicts, so runtime-only
    restrictions (resident self-anti-affinity) may be applied to `mask`.
    CPU tensors take the plain version, CUDA tensors the kernel (K2)."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels.wavefront_kernel import (
        pack_groups_wavefront as wavefront_pack,
    )

    return wavefront_pack(free, mask, req, count, limit_one, plan.waves)


def ffd_order(req: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Decreasing-size group order over a float32 cpu+memory score; invalid
    rows sort last. The sort is stable, as the reference's `jnp.argsort`,
    so groups with equal scores keep their index order."""
    score = (req[:, 0].to(torch.float32)
             + req[:, 1].to(torch.float32) / 1024.0)
    score = torch.where(valid, score, -1.0)
    return torch.argsort(-score, stable=True).to(torch.int32)

"""Seeded inputs for K2 (`wavefront_kernel.pack_groups_wavefront`): the cases
that `chip_smoke.py` and `tests/test_torch_kernels_cuda.py` hold byte-equal
to the plain version on the card, and `tests/test_torch_wavefront.py` holds
the plain version to the JAX package's `ops/pack.pack_groups_wavefront`.

`CASES` maps each case's name to a builder; a builder returns
[free, mask, req, count, limit_one, waves] on the CPU. Besides fuzzed plans,
the cases reach every branch of `csrc/wavefront.cu`: waves with more
(slot, lane chunk) tasks than a CTA has warps, waves whose slots are all
dead, live slots with no lane that has room, the partitioned plan's mostly
dead first wave, overlapping slots, negative counts, zero requests, mask
bit 31, lane ranges split unevenly over the cluster (and CTAs with no
lane), several lane chunks a CTA, and N beyond what the CTAs' shared memory
holds of the free plane (and beyond the old one-CTA limit).
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_autoscaler_tpu_torch.ops.pack import build_wavefront_plan, ffd_order


def _plan(mask, req, active=None):
    """The plan of `mask` in FFD order, as the port's planner builds it."""
    g = req.shape[0]
    order = ffd_order(req, torch.ones((g,), dtype=torch.bool))
    return build_wavefront_plan(mask.numpy(), order.numpy(), active=active,
                                device="cpu").waves


def wave_case(seed, g, n, r=8, style="mixed", max_count=3000, limit_share=0.3):
    """[free, mask, req, count, limit_one, waves], seeded, on the CPU, with
    the plan built from the mask in FFD order. Mask styles as the JAX
    package's tests/test_wavefront_pack.py generator: "overlap" rows overlap
    everything, "disjoint" rows take one of four node blocks, "sparse" rows
    are sparse random; "mixed" cycles the three. Group 0 requests nothing."""
    rng = np.random.default_rng(seed)
    free = rng.integers(0, 40, size=(n, r)).astype(np.int32)
    req = rng.integers(0, 6, size=(g, r)).astype(np.int32)
    req[0] = 0
    count = rng.integers(0, max_count, size=(g,)).astype(np.int32)
    mask = np.zeros((g, n), bool)
    for gi in range(g):
        kind = style if style != "mixed" else ("overlap", "disjoint",
                                               "sparse")[gi % 3]
        if kind == "overlap":
            mask[gi] = rng.random(n) < 0.6
        elif kind == "disjoint":
            blk = gi % 4
            mask[gi, blk * (n // 4):(blk + 1) * (n // 4)] = True
        else:
            mask[gi] = rng.random(n) < 0.2
    limit_one = rng.random(g) < limit_share
    a = [torch.from_numpy(x) for x in (free, mask, req, count, limit_one)]
    return a + [_plan(a[1], a[2])]


def _partition(seed, g, n, blocks):
    """`g` groups, group i feasible on node block i % blocks only: every
    wave holds `blocks` disjoint slots."""
    a = wave_case(seed, g, n, style="disjoint")
    a[1].zero_()
    width = n // blocks
    for gi in range(g):
        b = gi % blocks
        a[1][gi, b * width:(b + 1) * width] = True
    a[5] = _plan(a[1], a[2])
    return a


def _one_wave(seed, g, n):
    """A perfect partition of the lanes: one wave of `g` live slots."""
    return _partition(seed, g, n, g)


def _every_mask_overlaps():
    a = wave_case(4, 24, 2048)
    a[1].fill_(True)
    a[5] = _plan(a[1], a[2])
    return a


def _runtime_subset():
    a = wave_case(5, 48, 3000)
    keep = torch.from_numpy(np.random.default_rng(5).random(tuple(a[1].shape)) < 0.7)
    a[1] = a[1] & keep                            # the plan keeps the superset
    return a


def _overlapping_slots():
    a = wave_case(6, 40, 1500, style="overlap")
    a[5] = torch.arange(40, dtype=torch.int32).reshape(5, 8)
    return a


def _negative():
    a = wave_case(14, 24, 2000, style="disjoint")
    a[3][::3] = -a[3][::3] - 1                    # the formula's result
    return a


def _zero_requests():
    a = wave_case(8, 3, 200, style="overlap")
    a[0].zero_()
    a[2].zero_()
    a[3] = torch.tensor([7, 0, 2 ** 30], dtype=torch.int32)
    return a


def _bit31():
    a = wave_case(9, 32, 300)
    a[1].zero_()
    a[1][31, :] = True
    a[5] = _plan(a[1], a[2])
    return a


def _dead_waves():
    """Waves 1 and 3 hold only dead slots (count 0, or a positive count and
    no mask bit); waves 0 and 2 mix dead and live ones; groups 14 to 23 sit
    in no slot."""
    a = wave_case(21, 24, 1500, style="disjoint")
    a[3][[1, 5, 9, 13]] = 0
    a[1][[2, 6, 10, 12]] = False
    a[5] = torch.tensor([[0, 1, 2, 3, -1, -1],
                         [5, 6, 9, 10, -1, -1],
                         [4, 8, 12, 7, 11, -1],
                         [-1, 13, -1, -1, -1, -1]], dtype=torch.int32)
    return a


def _no_room():
    """Live slots with a positive count and mask bits, but no lane with
    room: the free plane is zero where they are feasible."""
    a = _partition(22, 16, 1024, 4)
    a[0][256:512] = 0                             # block 1: groups 1, 5, 9, 13
    a[0][768:, 2] = 0                             # block 3, one resource
    a[2][3::4, 2] = 1                             # ...which groups 3, 7, 11, 15 need
    return a


def _partitioned_plan():
    """The partitioned world's plan shape: 25 active groups in 5 node pools
    (5 waves of 5 disjoint slots) and 39 inactive groups, all put into
    wave 0 by the planner: wave 0 holds 5 live and 39 dead slots."""
    a = _partition(23, 64, 5120, 5)
    a[3][25:] = 0
    a[1][25:][::2] = False                        # half the inactive rows empty too
    a[5] = _plan(a[1], a[2], active=(a[3] > 0).numpy())
    return a


CASES = {
    **{f"fuzzed {style} masks G=64 N=5120": (lambda s=s, style=style:
                                              wave_case(s, 64, 5120, style=style))
       for s, style in enumerate(("mixed", "overlap", "disjoint"))},
    "partitioned plan: wave 0 of 5 live and 39 dead slots, G=64 N=5120":
        _partitioned_plan,
    "W == 1: 64 disjoint slots (more slot tasks than warps)":
        lambda: _one_wave(3, 64, 4096),
    "W == 1: 20 disjoint slots": lambda: _one_wave(24, 20, 2000),
    "W == G: every mask overlaps every other": _every_mask_overlaps,
    "runtime mask a strict subset of the plan mask": _runtime_subset,
    "plan with overlapping slots (segmented semantics)": _overlapping_slots,
    "waves whose slots are all dead": _dead_waves,
    "live slots with no lane that has room": _no_room,
    "every group limit_one": lambda: wave_case(7, 16, 700, limit_share=1.0),
    "negative counts": _negative,
    "zero-request groups on empty nodes": _zero_requests,
    "only group 31 (the sign bit) feasible": _bit31,
    "G=33 (two mask words)": lambda: wave_case(10, 33, 512),
    "N=1031, not a multiple of a warp": lambda: wave_case(11, 12, 1031),
    "N=40: fewer lanes than CTAs have warps, CTAs with no lane":
        lambda: wave_case(12, 5, 40),
    "N=2047: lane ranges split unevenly over the cluster":
        lambda: wave_case(25, 20, 2047, style="overlap"),
    "N=8192": lambda: wave_case(13, 40, 8192),
    "N=20000: three row chunks": lambda: wave_case(26, 24, 20000),
    "N=50000: the free plane in device memory, beyond the old one-CTA limit":
        lambda: wave_case(27, 16, 50000, style="disjoint"),
}

"""Seeded inputs for the constrained wave placer
(`constrained_kernel.place_lanes` / `pack_lanes`): the cases that
`tests/test_torch_constrained_kernel.py` holds byte-equal to the JAX
package on the CPU, and that `chip_smoke.py` and
`tests/test_torch_kernels_cuda.py` hold byte-equal to the plain version on
the card.

`CASES` maps each case's name to a builder; a builder returns a `Case` on
the CPU. The inputs are random where the case does not pin them: the
function is defined for any values, so the constraint fields need not be
consistent with one world. Besides mixed lanes, the cases reach each
branch the kernel has: the first-pod bootstrap (with no node that can
take a pod, and beside limit_one), anti-self 1-per-zone, hostname and zone
spread at skew 1 and 2, keyless nodes, zero requests (the BIG fit beside
the prefix sums, whose fits sum past BIG and past 2^31), negative free
capacity, lanes inactive from the start (`active` false, want 0, not
constrained), drain lanes of different groups, zone ids every lane shares beside a
validity row per lane, option lanes with a zone a lane, and a zone spread
the MAX_WAVES cap cuts short. For the kernel's thread-block clusters: N
= 1,000 (a multiple of no slice) with zones whose nodes span two CTAs'
slices, limit_one beside zone caps, and groups whose count is 0 or
negative.

A "place" case runs through `place_lanes` (the kernel's place entry on the
card); `as_pack` also turns it into one `pack_lanes` call over the same
lanes, which reaches the pack entry's branches from the same inputs.
`group_case` is one zone-spread group at the constrained world's width
(N = 5,120, R = 8), the arguments of `ops/constrained.place_group_constrained`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kubernetes_autoscaler_tpu_torch.ops.constrained import (
    BIG,
    GroupConstraints,
)
from kubernetes_autoscaler_tpu_torch.ops.pack import ffd_order

Z = 16  # Dims().max_zones


@dataclass
class Case:
    """`kind` "place": args = (free, feas, req, want, limit_one, cons,
    max_zones) with `active` (or None); "pack": args = (free, mask, req,
    count, order, limit_one, cons, max_zones)."""

    kind: str
    args: tuple
    active: torch.Tensor | None = None

    def to(self, device) -> "Case":
        def mv(x):
            if isinstance(x, torch.Tensor):
                return x.to(device)
            if isinstance(x, GroupConstraints):
                return GroupConstraints(**{k: v.to(device)
                                           for k, v in vars(x).items()})
            return x

        return Case(self.kind, tuple(mv(a) for a in self.args),
                    None if self.active is None else self.active.to(device))

    def run(self, place, pack):
        """The case through `place` (a place_lanes) or `pack` (a
        pack_lanes); returns a flat tuple of output tensors."""
        if self.kind == "place":
            return tuple(place(*self.args, active=self.active))
        res = pack(*self.args)
        return res.free_after, res.placed, res.scheduled


def as_pack(case: Case) -> Case:
    """A "place" case as one pack_lanes call of its B lanes: group g is
    lane g's group (its request, count, limit_one and constraints), and
    lane b's mask admits only its own group b, so each lane places its own
    group alone (by waves where it is constrained, by the one-shot first
    fit where not); an inactive lane's group has count 0. A "pack" case is
    returned as it is."""
    if case.kind == "pack":
        return case
    free, feas, req, want, limit, cons, z = case.args
    b, n = want.shape[0], feas.shape[-1]
    r = free.shape[-1]
    count = want.clone()
    if case.active is not None:
        count[~case.active] = 0
    eye = torch.eye(b, dtype=torch.bool)
    mask = eye[:, :, None] & feas.expand(b, n)[None, :, :]
    fields = {}
    for k, v in vars(cons).items():
        if k in ("zone_cl", "zone_valid"):
            fields[k] = v
        else:
            v = v.expand((b,) + tuple(v.shape[1:]))
            fields[k] = v[None].expand((b,) + tuple(v.shape)).contiguous()
    return Case("pack", (
        free.expand(b, n, r).contiguous(), mask.contiguous(),
        req.expand(b, r).contiguous(), count,
        torch.arange(b, dtype=torch.int32), limit.expand(b).contiguous(),
        GroupConstraints(**fields), z))


def _t(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _cons(rng, lead, n, kinds=None, zone_rows=None):
    """Random GroupConstraints with fields [*lead, ...] over Z zones, node
    zones drawn from the first four; zone rows [L, N] (`zone_rows` =
    (zone_cl, zone_valid) overrides)."""
    i32, b8 = torch.int32, torch.bool
    kinds = kinds or {}

    def pick(name, default):
        v = kinds.get(name)
        if v is None:
            return default
        return np.broadcast_to(np.asarray(v), lead).copy()

    s_kind = pick("s_kind", rng.integers(0, 3, lead))
    a_kind = pick("a_kind", rng.integers(0, 3, lead))
    anti = pick("anti", rng.random(lead) < 0.2)
    if zone_rows is None:
        zcl = rng.integers(0, 4, (lead[0], n))
        zval = rng.random((lead[0], n)) < 0.85
    else:
        zcl, zval = zone_rows
    mhb = np.where(rng.random(lead) < 0.5, BIG, rng.integers(0, 4, lead))
    return GroupConstraints(
        s_kind=_t(s_kind, i32),
        s_skew=_t(pick("skew", rng.integers(1, 3, lead)), i32),
        s_self=_t(pick("s_self", rng.random(lead) < 0.7), b8),
        s_cnt_node=_t(rng.integers(0, 4, lead + (n,)), i32),
        s_elig=_t(rng.random(lead + (n,)) < 0.9, b8),
        a_kind=_t(a_kind, i32),
        a_self=_t(pick("a_self", rng.random(lead) < 0.6), b8),
        a_any=_t(pick("a_any", rng.random(lead) < 0.4), b8),
        a_ok_node=_t(rng.random(lead + (n,)) < 0.5 if "a_ok" not in kinds
                     else np.broadcast_to(kinds["a_ok"], lead + (n,)), b8),
        anti_self_zone=_t(anti, b8),
        cnt_zone_base=_t(rng.integers(0, 6, lead + (Z,)), i32),
        elig_zone_base=_t(rng.random(lead + (Z,)) < 0.8, b8),
        min_host_base=_t(mhb, i32),
        zone_cl=_t(np.clip(zcl, 0, Z - 1), i32),
        zone_valid=_t(zval, b8))


def place_case(seed, b, n, r=4, want_max=40, kinds=None, shared_zone=False,
               active_p=1.0, zone_rows=None):
    """B lanes of one group each (drain lanes): free [B, N, R], per-lane
    req, want, limit_one and constraints; zone rows shared ([1, N]) with
    `shared_zone`."""
    rng = np.random.default_rng(seed)
    kinds = dict(kinds or {})
    lim = kinds.pop("limit", None)
    free = rng.integers(-2, 40, (b, n, r))
    req = rng.integers(0, 6, (b, r))
    req[0] = 0                                    # a zero-request lane
    want = rng.integers(0, want_max, (b,))
    limit = rng.random((b,)) < 0.2
    if zone_rows is None and shared_zone:
        zone_rows = (rng.integers(0, 4, (1, n)), rng.random((1, n)) < 0.85)
    cons = _cons(rng, (b,), n, kinds=kinds, zone_rows=zone_rows)
    if lim is not None:
        limit = np.broadcast_to(lim, (b,))
    active = None if active_p >= 1.0 else _t(rng.random((b,)) < active_p,
                                             torch.bool)
    return Case("place", (
        _t(free, torch.int32), _t(rng.random((b, n)) < 0.8, torch.bool),
        _t(req, torch.int32), _t(want, torch.int32), _t(limit, torch.bool),
        cons, Z), active)


def pack_case(seed, b, g, n, r=4, count_max=60, kinds=None, lane_zone=False,
              zone_rows=None):
    """B lanes of the whole group loop: free [B, N, R], mask [B, G, N],
    shared req/count/order/limit_one, constraints [B, G, ...]; with
    `lane_zone` each lane's nodes all carry that lane's zone (the options:
    one template a lane, its bins in the template's zone, a keyless
    template too); `zone_rows` = (zone_cl, zone_valid) [L, N] overrides."""
    rng = np.random.default_rng(seed)
    free = rng.integers(-2, 40, (b, n, r))
    req = rng.integers(0, 6, (g, r))
    req[0] = 0
    count = rng.integers(0, count_max, (g,))
    mask = rng.random((b, g, n)) < 0.8
    limit = rng.random((g,)) < 0.2
    if lane_zone:
        lz = rng.integers(0, 4, (b,))
        zone_rows = (np.repeat(lz[:, None], n, 1),
                     np.repeat((np.arange(b) % 3 != 2)[:, None], n, 1))
    cons = _cons(rng, (b, g), n, kinds=kinds, zone_rows=zone_rows)
    req_t = _t(req, torch.int32)
    return Case("pack", (
        _t(free, torch.int32), _t(mask, torch.bool), req_t,
        _t(count, torch.int32),
        ffd_order(req_t, torch.ones((g,), dtype=torch.bool)),
        _t(limit, torch.bool), cons, Z))


def _zero_requests():
    """Zero requests and wants near 2^27 and 2^30: every fit is BIG or the
    want, the fits sum past BIG (the zone pass runs with no zone kind) and
    past 2^31 (the prefix sums wrap as the plain version's int32 does)."""
    c = place_case(5, 6, 48, kinds={"s_kind": 0, "a_kind": 0, "anti": False})
    free, feas, req, want, limit, cons, z = c.args
    req.zero_()
    want.copy_(torch.tensor([2 ** 27 + 5, 2 ** 30, 7, 2 ** 31 - 1, 0, 100],
                            dtype=torch.int32))
    return c


def _max_waves():
    """A zone spread with maxSkew 1 over three zones, self-counted, plenty
    of room: three pods a wave, cut at MAX_WAVES (384 of 2,000)."""
    n = 60
    zcl = np.tile(np.arange(3), n // 3)[None]
    c = place_case(9, 1, n, kinds={"s_kind": 2, "skew": 1, "s_self": True,
                                   "a_kind": 0, "anti": False},
                   zone_rows=(zcl, np.ones((1, n), bool)))
    free, feas, req, want, limit, cons, z = c.args
    free.fill_(1000)
    feas.fill_(True)
    req.fill_(1)
    want.fill_(2000)
    limit.fill_(False)
    cons.cnt_zone_base.zero_()
    cons.elig_zone_base.zero_()
    cons.elig_zone_base[:, :3] = True
    return c


def _inactive():
    """Lanes inactive from the start: `active` false, want 0, and lanes
    whose group is not constrained (place_lanes runs waves for them all the
    same)."""
    c = place_case(13, 8, 50, active_p=0.5)
    c.args[3][1::3] = 0
    c.args[5].s_kind[::2] = 0
    c.args[5].a_kind[::2] = 0
    c.args[5].anti_self_zone[::2] = False
    return c


def _bootstrap(limit):
    def build():
        c = place_case(17 + limit, 6, 40,
                       kinds={"a_kind": [1, 2, 1, 2, 1, 2], "a_self": True,
                              "a_any": False, "a_ok": False, "s_kind": 0,
                              "anti": False, "limit": limit})
        c.args[1][0] = False                      # no node can take a pod
        c.args[1][3, :17] = False                 # the seed is node 17
        return c
    return build


def _spanning_zones():
    """N = 1,000 nodes (a slice of 250 at a cluster of 4, of 63 at 16: a
    multiple of neither), zones in runs of 300 nodes, so a zone's nodes
    span two or more CTAs' slices, every kind of group, keyless nodes."""
    n = 1000
    zcl = (np.arange(n) // 300)[None] % 4
    zval = (np.arange(n) % 37 != 0)[None]
    return pack_case(45, 1, 12, n, r=4, count_max=400,
                     zone_rows=(zcl, zval))


def _limit_one_caps():
    """limit_one beside zone caps: zone spreads at skew 1 and 2 and
    anti-self 1-per-zone, every lane limit_one."""
    return place_case(47, 6, 90, want_max=120,
                      kinds={"s_kind": 2, "limit": True,
                             "anti": [True, False, True, False, True, False]})


def _count_zero():
    """Groups whose count is 0 or negative beside live ones, constrained
    and not: they place nothing and run no wave."""
    c = pack_case(49, 2, 10, 80, count_max=40)
    c.args[3][::3] = 0
    c.args[3][1] = -5
    return c


def group_case(seed=51, n=5120, r=8, want=2000):
    """(free [N, R], feas [N], req [R], want, limit_one, cons, Z): one
    group with a self-counted zone spread at maxSkew 1 over three zones
    (three pods a wave, cut at MAX_WAVES), its fields without the group
    axis, as `place_group_constrained` takes them."""
    zcl = (np.arange(n) % 3)[None]
    c = place_case(seed, 1, n, r=r, kinds={"s_kind": 2, "skew": 1,
                                           "s_self": True, "a_kind": 0,
                                           "anti": False},
                   zone_rows=(zcl, np.ones((1, n), bool)))
    free, feas, req, want_t, limit, cons, z = c.args
    free.clamp_(min=0)
    limit.zero_()
    cons.cnt_zone_base.zero_()
    cons.elig_zone_base.zero_()
    cons.elig_zone_base[:, :3] = True
    req[0] = torch.tensor([1, 2, 0, 1, 0, 3, 1, 0][:r], dtype=torch.int32)
    want_t.fill_(want)
    return (free[0], feas[0], req[0], want_t[0], limit[0],
            GroupConstraints(**{k: v[0] for k, v in vars(cons).items()}), z)


CASES = {
    "bootstrap": _bootstrap(False),
    "limit_one_bootstrap": _bootstrap(True),
    "anti_self_zone": lambda: place_case(
        21, 6, 45, kinds={"anti": True, "s_kind": 0, "a_kind": 0}),
    "host_spread_skew1": lambda: place_case(
        23, 6, 45, kinds={"s_kind": 1, "skew": 1, "a_kind": 0,
                          "anti": False}),
    "host_spread_skew2": lambda: place_case(
        25, 6, 45, kinds={"s_kind": 1, "skew": 2, "a_kind": 0,
                          "anti": False}),
    "zone_spread_skew1": lambda: place_case(
        27, 6, 45, want_max=200, kinds={"s_kind": 2, "skew": 1,
                                        "a_kind": 0}),
    "zone_spread_skew2": lambda: place_case(
        29, 6, 45, want_max=200, kinds={"s_kind": 2, "skew": 2,
                                        "a_kind": 0}),
    "keyless_nodes": lambda: place_case(
        31, 6, 45, want_max=120, kinds={"s_kind": 2, "anti": True},
        zone_rows=(np.random.default_rng(1).integers(0, 3, (6, 45)),
                   np.random.default_rng(2).random((6, 45)) < 0.3)),
    "zero_requests": _zero_requests,
    "inactive_lanes": _inactive,
    "drain_lanes": lambda: place_case(35, 24, 64, shared_zone=True,
                                      active_p=0.6),
    "shared_zone_ids_lane_validity": lambda: place_case(
        39, 5, 40, want_max=80, kinds={"anti": True},
        zone_rows=(np.random.default_rng(3).integers(0, 3, (1, 40)),
                   np.random.default_rng(4).random((5, 40)) < 0.7)),
    "option_lanes": lambda: pack_case(37, 6, 10, 32, lane_zone=True),
    "max_waves": _max_waves,
    "filter_pack": lambda: pack_case(41, 1, 24, 150),
    "mixed_pack": lambda: pack_case(43, 3, 12, 70, count_max=300),
    "spanning_zones": _spanning_zones,
    "limit_one_caps": _limit_one_caps,
    "count_zero": _count_zero,
}

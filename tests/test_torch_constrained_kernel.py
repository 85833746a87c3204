"""The constrained wave placer's plain versions
(ops/kernels/constrained_kernel.py) against the JAX package's
`place_group_constrained` and `pack_groups_constrained`, on the CPU.

Every case of `ops/kernels/con_cases.CASES` (numpy inputs from a seed, at
small widths) goes through the port's wrappers, which take the plain
versions for CPU tensors, and through the reference lane by lane (its vmap
written out; plain jnp, jitted, on the CPU). Outputs are byte-equal: the
function is int32 and bool throughout, wrap-around included. The same
cases hold the CUDA kernel to the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).

Also here: the wrappers' input contract, which holds on either device, and
`active` / `out`, the drain's way of passing all its lanes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_autoscaler_tpu.ops import constrained as ref_con
from kubernetes_autoscaler_tpu_torch.ops import constrained
from kubernetes_autoscaler_tpu_torch.ops.kernels import (
    con_cases,
    constrained_kernel,
)

_ref_place = jax.jit(ref_con.place_group_constrained, static_argnums=6)
_ref_pack = jax.jit(ref_con.pack_groups_constrained, static_argnums=7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny inputs: one intra-op thread keeps this file off the other test
    workers' cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _row(t: torch.Tensor, i: int) -> jnp.ndarray:
    """Lane i of a lane input ([1, ...] is every lane's row)."""
    return jnp.asarray(t[0 if t.shape[0] == 1 else i].numpy())


def _ref_cons(cons, i: int):
    return ref_con.GroupConstraints(**{k: _row(v, i)
                                       for k, v in vars(cons).items()})


def reference(case: con_cases.Case) -> tuple[np.ndarray, ...]:
    """The case through the JAX package, lane by lane."""
    if case.kind == "place":
        free, feas, req, want, limit, cons, z = case.args
        outs = []
        for i in range(want.shape[0]):
            w = want[i]
            if case.active is not None and not bool(case.active[i]):
                w = torch.zeros_like(w)     # an inactive lane places nothing
            outs.append(_ref_place(_row(free, i), _row(feas, i), _row(req, i),
                                   jnp.asarray(w.numpy()), _row(limit, i),
                                   _ref_cons(cons, i), z))
        return tuple(np.stack([np.asarray(o[k]) for o in outs])
                     for k in range(2))
    free, mask, req, count, order, limit, cons, z = case.args
    outs = [_ref_pack(_row(free, i), _row(mask, i), jnp.asarray(req.numpy()),
                      jnp.asarray(count.numpy()), jnp.asarray(order.numpy()),
                      jnp.asarray(limit.numpy()), _ref_cons(cons, i), z)
            for i in range(free.shape[0])]
    return tuple(np.stack([np.asarray(getattr(o, k)) for o in outs])
                 for k in ("free_after", "placed", "scheduled"))


def assert_equal(want, got):
    assert len(want) == len(got)
    for k, (w, g) in enumerate(zip(want, got)):
        g = g.numpy()
        assert w.dtype == g.dtype and w.shape == g.shape, \
            (k, w.dtype, w.shape, g.dtype, g.shape)
        assert w.tobytes() == g.tobytes(), f"output {k} differs"


@pytest.mark.parametrize("name", list(con_cases.CASES))
def test_plain_matches_reference(name):
    case = con_cases.CASES[name]()
    got = case.run(constrained_kernel.place_lanes,
                   constrained_kernel.pack_lanes)
    assert_equal(reference(case), got)


def test_cases_reach_their_edges():
    """The cases pin what their names say: the MAX_WAVES cap cuts the zone
    spread at 384 of 2,000; the zero-request wants sum past 2^31; the
    bootstrap lane with no feasible node places nothing; the option lanes
    have one zone a lane."""
    got = con_cases.CASES["max_waves"]().run(constrained_kernel.place_lanes,
                                             constrained_kernel.pack_lanes)
    assert int(got[1].sum()) == 3 * constrained.MAX_WAVES == 384
    zero = con_cases.CASES["zero_requests"]()
    assert int(zero.args[3].long().sum()) > 2 ** 31
    boot = con_cases.CASES["bootstrap"]()
    place = boot.run(constrained_kernel.place_lanes,
                     constrained_kernel.pack_lanes)[1]
    assert int(place[0].sum()) == 0 and int(place.sum()) > 0
    opt = con_cases.CASES["option_lanes"]()
    zcl = opt.args[6].zone_cl
    assert bool((zcl == zcl[:, :1]).all())


def test_place_group_constrained_matches_reference():
    """`ops/constrained.place_group_constrained` on con_cases.group_case
    (the constrained world's width, one zone-spread group cut at
    MAX_WAVES): byte-equal to the reference's."""
    free, feas, req, want, limit, cons, z = con_cases.group_case()
    ref = _ref_place(*(jnp.asarray(t.numpy()) for t in
                       (free, feas, req, want, limit)),
                     ref_con.GroupConstraints(**{
                         k: jnp.asarray(v.numpy())
                         for k, v in vars(cons).items()}), z)
    got = constrained.place_group_constrained(free, feas, req, want, limit,
                                              cons, z)
    assert_equal(tuple(np.asarray(r) for r in ref), got)
    assert int(got[1].sum()) == 3 * constrained.MAX_WAVES


def test_active_leaves_out_untouched():
    """`active` false leaves a lane as `out` holds it; the active lanes are
    what a call over them alone gives."""
    case = con_cases.CASES["drain_lanes"]()
    free, feas, req, want, limit, cons, z = case.args
    b, n, r = free.shape
    out = (torch.full((b, n, r), -7, dtype=torch.int32),
           torch.full((b, n), -9, dtype=torch.int32))
    reads = constrained_kernel.place_lanes.flag_reads
    got = constrained_kernel.place_lanes(free, feas, req, want, limit, cons, z,
                                  active=case.active, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    assert constrained_kernel.place_lanes.flag_reads > reads
    off = ~case.active
    assert bool((out[0][off] == -7).all()) and bool((out[1][off] == -9).all())
    alone = constrained_kernel.place_lanes(free, feas, req, want, limit, cons, z)
    on = case.active
    assert torch.equal(out[0][on], alone[0][on])
    assert torch.equal(out[1][on], alone[1][on])


def _place_args():
    case = con_cases.CASES["drain_lanes"]()
    return list(case.args), case.active


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "device_mix",
                                 "zones", "active"])
def test_place_lanes_rejects_what_the_kernel_does_not_take(bad):
    """The contract holds on the CPU too, so the CPU tests hold callers to
    what the kernel takes."""
    args, active = _place_args()
    free, feas, req, want, limit, cons, z = args
    kw = {"active": active}
    if bad == "dtype":
        args[0] = free.long()
    elif bad == "shape":
        args[1] = feas[:, :-1]
    elif bad == "strided":
        args[3] = torch.stack([want, want], 1)[:, 0]
    elif bad == "device_mix":
        args[0] = free.to("meta")
    elif bad == "zones":
        args[6] = z + 1
    else:
        kw["active"] = active.to(torch.int32)
    with pytest.raises((TypeError, ValueError)):
        constrained_kernel.place_lanes(*args, **kw)


@pytest.mark.parametrize("bad", ["mask_dtype", "order_strided",
                                 "cons_strided", "req_shape"])
def test_pack_lanes_rejects_what_the_kernel_does_not_take(bad):
    args = list(con_cases.CASES["mixed_pack"]().args)
    free, mask, req, count, order, limit, cons, z = args
    if bad == "mask_dtype":
        args[1] = mask.to(torch.uint8)
    elif bad == "order_strided":
        args[4] = torch.stack([order, order], 1)[:, 0]
    elif bad == "cons_strided":
        args[6] = cons.replace(
            s_elig=cons.s_elig.transpose(1, 2).contiguous().transpose(1, 2))
    else:
        args[2] = req[:, :-1]
    with pytest.raises((TypeError, ValueError)):
        constrained_kernel.pack_lanes(*args)


def test_shared_rows_take_stride_zero():
    """A row every lane shares may come as [1, ...] or as a stride-0
    expansion; both give the per-lane result."""
    case = con_cases.CASES["drain_lanes"]()
    free, feas, req, want, limit, cons, z = case.args
    b = want.shape[0]
    got = constrained_kernel.place_lanes(free[:1].expand(b, -1, -1), feas,
                                         req, want, limit, cons, z)
    per_lane = constrained_kernel.place_lanes(
        free[:1].expand(b, -1, -1).contiguous(), feas, req, want, limit,
        cons, z)
    assert torch.equal(got[0], per_lane[0]) and torch.equal(got[1],
                                                            per_lane[1])
    assert constrained_kernel._lane("zone_cl", cons.zone_cl, torch.int32, b,
                                    (feas.shape[1],), free.device) == 0


def test_pack_lanes_constrained_group_with_no_pods_places_nothing():
    """A constrained group whose count is not positive runs no wave and
    places nothing on its constrained lanes (the reference's `slow` with
    rem <= 0), even where the one-shot first fit would place a negative
    count."""
    case = con_cases.CASES["mixed_pack"]()
    free, mask, req, count, order, limit, cons, z = case.args
    count = count.clone()
    count[::2] = -3
    case = con_cases.Case("pack", (free, mask, req, count, order, limit, cons,
                                   z))
    got = case.run(constrained_kernel.place_lanes,
                   constrained_kernel.pack_lanes)
    assert_equal(reference(case), got)
    con = cons.is_constrained()
    neg = (count < 0)[None, :] & con
    assert bool((got[1].sum(-1)[neg] == 0).all())


def test_cluster_cases_reach_their_edges():
    """The cases for the kernel's thread-block clusters pin their edges:
    N = 1,000 is no multiple of a cluster of 16's slice (63 nodes), and a
    zone's nodes cross the slices' edges at clusters of 2, 4 and 16; every
    lane of
    "limit_one_caps" is limit_one beside a zone cap and places at most one
    pod a node; "count_zero"'s groups of count 0 or below place nothing."""
    n = 1000
    case = con_cases.CASES["spanning_zones"]()
    zcl = case.args[6].zone_cl[0]
    assert n % 63
    for ns in (500, 250, 63):
        edges = torch.arange(ns, n, ns)
        assert bool((zcl[edges] == zcl[edges - 1]).any())
    got = case.run(constrained_kernel.place_lanes,
                   constrained_kernel.pack_lanes)
    assert_equal(reference(case), got)
    assert int(got[1].sum()) > 0
    caps = con_cases.CASES["limit_one_caps"]()
    assert bool(caps.args[4].all()) and bool((caps.args[5].s_kind == 2).all())
    place = caps.run(constrained_kernel.place_lanes,
                     constrained_kernel.pack_lanes)[1]
    assert int(place.max()) == 1 and int(place.sum()) > 0
    zero = con_cases.CASES["count_zero"]()
    count = zero.args[3]
    got = zero.run(constrained_kernel.place_lanes,
                   constrained_kernel.pack_lanes)
    assert bool((got[1].sum(-1)[:, count <= 0] == 0).all())
    assert int(got[1].sum()) > 0


@pytest.mark.parametrize("name", [k for k, v in con_cases.CASES.items()
                                  if v().kind == "place"])
def test_as_pack_places_each_lane_alone(name):
    """`con_cases.as_pack` (how the card runs a "place" case through the
    pack kernel) gives each constrained lane's group the placement
    place_lanes gives that lane; both are the JAX package's."""
    case = con_cases.CASES[name]()
    want = case.run(constrained_kernel.place_lanes,
                    constrained_kernel.pack_lanes)
    pack = con_cases.as_pack(case)
    got = pack.run(constrained_kernel.place_lanes,
                   constrained_kernel.pack_lanes)
    assert_equal(reference(pack), got)
    con = case.args[5].is_constrained().expand(want[1].shape[0])
    for b in range(want[1].shape[0]):
        if bool(con[b]):
            assert torch.equal(got[1][b, b], want[1][b]), b

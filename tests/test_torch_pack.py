"""The PyTorch port's pack primitives and device modules against the JAX
reference, on the same seeded numpy inputs.

Inputs reach the port through `from_numpy` (the state carry-across) or as
the same numpy arrays. Tolerance: none — every compared output is integer or
bool and must be byte-identical. On the CPU the pack wrapper takes the plain
version; the kernel itself is held against that plain version on the card
(tests/test_torch_kernels_cuda.py and chip_smoke.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import PORT, REF, assert_trees_equal, build_world, encode_world

from kubernetes_autoscaler_tpu.models.cluster_state import Dims as RefDims
from kubernetes_autoscaler_tpu.ops import bitplane as ref_bits
from kubernetes_autoscaler_tpu.ops import binpack as ref_binpack
from kubernetes_autoscaler_tpu.ops import drain as ref_drain
from kubernetes_autoscaler_tpu.ops import pack as ref_pack
from kubernetes_autoscaler_tpu.ops import predicates as ref_preds
from kubernetes_autoscaler_tpu.ops import schedule as ref_schedule
from kubernetes_autoscaler_tpu_torch.models.cluster_state import Dims, from_numpy
from kubernetes_autoscaler_tpu_torch.ops import binpack, bitplane, drain, pack
from kubernetes_autoscaler_tpu_torch.ops import predicates, schedule
from kubernetes_autoscaler_tpu_torch.ops.kernels import pack_kernel


def _port(tree):
    """A reference tree carried across into the port, on the CPU."""
    return from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rand_instance(rng, n, g, r=4, max_req=6, max_cap=40, max_count=30):
    """numpy (free, mask, req, count, order, limit_one), as in the
    reference's tests/test_pallas_pack.py."""
    free = rng.integers(0, max_cap, size=(n, r)).astype(np.int32)
    req = rng.integers(0, max_req, size=(g, r)).astype(np.int32)
    count = rng.integers(0, max_count, size=(g,)).astype(np.int32)
    mask = rng.random((g, n)) < 0.8
    limit_one = rng.random((g,)) < 0.2
    order = np.asarray(ref_pack.ffd_order(jnp.asarray(req),
                                          jnp.ones((g,), bool)))
    return free, mask, req, count, order, limit_one


def _assert_pack_equal(ref, got):
    for name in ("placed", "scheduled", "free_after"):
        a = np.asarray(getattr(ref, name))
        b = getattr(got, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def _both_pack(args):
    ref = ref_pack.pack_groups(*[jnp.asarray(a) for a in args])
    got = pack.pack_groups(*[_t(a) for a in args])
    _assert_pack_equal(ref, got)
    return got


def test_fit_count_matches_reference():
    rng = np.random.default_rng(5)
    free = rng.integers(-5, 50, size=(40, 8)).astype(np.int32)
    for req in (rng.integers(0, 7, size=(8,)).astype(np.int32),
                np.zeros((8,), np.int32),
                np.asarray([2, 1, 0, 0, 0, 0, 0, 0], np.int32)):
        ref = np.asarray(ref_pack.fit_count(jnp.asarray(free), jnp.asarray(req)))
        got = pack.fit_count(_t(free), _t(req)).numpy()
        assert ref.dtype == got.dtype and ref.tobytes() == got.tobytes()


def test_ffd_order_keeps_ties_in_index_order():
    # rows 0, 2, 5 tie and must keep their index order; row 3 is larger by
    # 1/1024 (exact in f32); row 4 is invalid and sorts last
    req = np.asarray([[500, 1024], [250, 0], [500, 1024], [500, 1024],
                      [4000, 0], [500, 1024], [0, 0]], np.int32)
    req[3, 1] = 1025
    req = np.concatenate([req, np.zeros((7, 6), np.int32)], axis=1)
    valid = np.asarray([1, 1, 1, 1, 0, 1, 1], bool)
    ref = np.asarray(ref_pack.ffd_order(jnp.asarray(req), jnp.asarray(valid)))
    got = pack.ffd_order(_t(req), _t(valid)).numpy()
    assert ref.dtype == got.dtype and ref.tobytes() == got.tobytes()
    assert list(got[:4]) == [3, 0, 2, 5]


@pytest.mark.parametrize("g", [31, 32, 33, 64])
def test_pack_group_bits_sign_bit_and_two_words(g):
    rng = np.random.default_rng(g)
    mask = rng.random((3, g, 17)) < 0.5
    mask[:, 31 % g, :] = True                  # bit 31: the sign bit
    want = ref_bits.pack_group_bits_np(mask)
    got = bitplane.pack_group_bits(_t(mask)).numpy()
    ref = np.asarray(ref_bits.pack_group_bits(jnp.asarray(mask)))
    assert got.dtype == np.int32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes() == ref.tobytes()
    if g >= 32:
        assert (got[:, 0, :] < 0).all()
    assert (bitplane.unpack_group_bits(_t(got), g).numpy() == mask).all()


@pytest.mark.parametrize("check_resources", [False, True])
def test_feasibility_mask_matches_reference(check_resources):
    ref_enc, ref_groups = encode_world(REF, build_world(REF, seed=4))
    nodes, specs = _port(ref_enc.nodes), _port(ref_enc.specs)
    ref = np.asarray(ref_preds.feasibility_mask(
        ref_enc.nodes, ref_enc.specs, check_resources=check_resources))
    got = predicates.feasibility_mask(nodes, specs,
                                      check_resources=check_resources).numpy()
    assert ref.tobytes() == got.tobytes()
    assert got.any() and not got.all()
    tmpl = ref_groups.as_node_tensors(RefDims())
    ref_t = np.asarray(ref_preds.feasibility_mask(tmpl, ref_enc.specs, False))
    got_t = predicates.feasibility_mask(
        _port(ref_groups).as_node_tensors(Dims()), specs, False).numpy()
    assert ref_t.tobytes() == got_t.tobytes()


# ---- the pack: cases of the reference's tests/test_pallas_pack.py ----


@pytest.mark.parametrize("seed", range(6))
def test_plain_pack_matches_reference_random(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 40))
    g = int(rng.integers(1, 12))
    _both_pack(_rand_instance(rng, n, g))


def test_plain_pack_matches_reference_tiled_spill():
    rng = np.random.default_rng(99)
    free, mask, req, count, order, limit_one = _rand_instance(rng, 300, 5)
    count = np.full((5,), 400, np.int32)       # spills across many nodes
    _both_pack((free, mask, req, count, order, limit_one))


def test_plain_pack_zero_request_group_no_overflow():
    n, g, r = 200, 2, 4
    args = (np.zeros((n, r), np.int32), np.ones((g, n), bool),
            np.zeros((g, r), np.int32), np.asarray([7, 0], np.int32),
            np.asarray([0, 1], np.int32), np.zeros((g,), bool))
    got = _both_pack(args)
    assert got.scheduled.tolist() == [7, 0]
    assert int(got.placed.max()) <= 7


def test_plain_pack_first_fit_order_contract():
    args = (np.asarray([[2, 10], [2, 10], [2, 10]], np.int32),
            np.ones((1, 3), bool), np.asarray([[1, 1]], np.int32),
            np.asarray([5], np.int32), np.asarray([0], np.int32),
            np.zeros((1,), bool))
    got = _both_pack(args)
    assert got.placed[0].tolist() == [2, 2, 1]


def test_plain_batched_rows_are_independent():
    rng = np.random.default_rng(7)
    free, mask, req, count, order, limit_one = _rand_instance(rng, 60, 6)
    rows = [free, free // 2, free * 0]
    got = pack_kernel.pack_groups_batched(
        _t(np.stack(rows)), _t(np.stack([mask] * 3)), _t(req), _t(count),
        _t(order), _t(limit_one))
    for i, fr in enumerate(rows):
        ref = ref_pack.pack_groups(*[jnp.asarray(a) for a in
                                     (fr, mask, req, count, order, limit_one)])
        assert np.asarray(ref.placed).tobytes() == got.placed[i].numpy().tobytes()
        assert (np.asarray(ref.free_after).tobytes()
                == got.free_after[i].numpy().tobytes())
        assert (np.asarray(ref.scheduled).tobytes()
                == got.scheduled[i].numpy().tobytes())


def test_plain_batched_matches_reference_pallas_interpret():
    """The one case that runs the reference Pallas kernel itself (interpret
    mode costs seconds per call): several node tiles and batch rows."""
    from kubernetes_autoscaler_tpu.ops.pallas.pack_kernel import (
        pack_groups_batched,
    )

    rng = np.random.default_rng(11)
    free, mask, req, count, order, limit_one = _rand_instance(rng, 300, 4)
    count = np.full((4,), 150, np.int32)
    free3 = np.stack([free, free // 3, free * 2])
    mask3 = np.stack([mask, mask, ~mask])
    ref = pack_groups_batched(
        jnp.asarray(free3), jnp.asarray(mask3), jnp.asarray(req),
        jnp.asarray(count), jnp.asarray(order), jnp.asarray(limit_one),
        tile=128, interpret=True)
    got = pack_kernel.pack_groups_batched(
        _t(free3), _t(mask3), _t(req), _t(count), _t(order), _t(limit_one))
    _assert_pack_equal(ref, got)


# ---- the device modules around the pack, fed through from_numpy ----


def test_schedule_estimate_and_drain_match_reference():
    ref_enc, ref_groups = encode_world(REF, build_world(REF, seed=6))
    nodes, specs = _port(ref_enc.nodes), _port(ref_enc.specs)
    sched, groups = _port(ref_enc.scheduled), _port(ref_groups)

    ref_rc = np.asarray(ref_schedule.resident_group_counts(
        ref_enc.scheduled, ref_enc.specs.g, ref_enc.nodes.n))
    got_rc = schedule.resident_group_counts(sched, specs.g, nodes.n).numpy()
    assert ref_rc.tobytes() == got_rc.tobytes() and got_rc.any()

    assert_trees_equal(
        ref_schedule.schedule_pending_on_existing(
            ref_enc.nodes, ref_enc.specs, ref_enc.scheduled),
        schedule.schedule_pending_on_existing(nodes, specs, sched))

    assert_trees_equal(
        ref_binpack.estimate_all(ref_enc.specs, ref_groups, RefDims(), 16),
        binpack.estimate_all(specs, groups, Dims(), 16))

    n = ref_enc.nodes.n
    cands = np.arange(n, dtype=np.int32)[::-1].copy()   # any order, any C
    allowed = np.arange(n) % 4 != 1
    ref = ref_drain.simulate_removals(
        ref_enc.nodes, ref_enc.specs, ref_enc.scheduled, jnp.asarray(cands),
        jnp.asarray(allowed), max_pods_per_node=8, chunk=8)
    for chunk in (8, 5, 64, None):           # chunk changes memory only
        got = drain.simulate_removals(nodes, specs, sched, _t(cands),
                                      _t(allowed), max_pods_per_node=8,
                                      chunk=chunk)
        assert_trees_equal(ref, got)
    assert got.drainable.any() and (got.dest_node >= 0).any()

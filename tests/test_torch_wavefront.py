"""The PyTorch port's phased path and wavefront packing against the JAX
reference, on the CPU.

Covered: the wavefront planner (compute_wavefronts, build_wavefront_plan,
WavefrontCache, plan_wavefronts), the plain wavefront pack (the version the
wrapper of kernel K2 takes on CPU tensors), the host fetch, best_option,
eligible_for_scale_down, and scale_up_sim / scale_down_sim / run_once_sim.
Inputs are the same seeded numpy arrays, or the same seeded world built and
encoded by each package's own object model. Tolerance: int and bool leaves
byte-identical; f32 leaves within rtol 1e-6 (the frameworks may sum in
another order), with the same chosen option. The kernel itself is held
against the plain version on the card (tests/test_torch_kernels_cuda.py and
chip_smoke.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_wavefront_pack import _random_instance as _instance
from torch_parity import (
    PORT,
    REF,
    assert_trees_equal,
    build_world,
    encode_world,
    leaves,
)

from kubernetes_autoscaler_tpu.metrics.phases import PhaseStats
from kubernetes_autoscaler_tpu.models.cluster_state import (
    ClusterTensors as RefClusterTensors,
)
from kubernetes_autoscaler_tpu.models.cluster_state import Dims as RefDims
from kubernetes_autoscaler_tpu.ops import autoscale_step as ref_step
from kubernetes_autoscaler_tpu.ops import bitplane as ref_bits
from kubernetes_autoscaler_tpu.ops import hostfetch as ref_fetch
from kubernetes_autoscaler_tpu.ops import pack as ref_pack
from kubernetes_autoscaler_tpu.ops import schedule as ref_schedule
from kubernetes_autoscaler_tpu.ops import scoring as ref_scoring
from kubernetes_autoscaler_tpu.ops import utilization as ref_util
from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    ClusterTensors,
    Dims,
    from_numpy,
)
from kubernetes_autoscaler_tpu_torch.ops import autoscale_step as port_step
from kubernetes_autoscaler_tpu_torch.ops import (
    bitplane,
    hostfetch,
    pack,
    schedule,
    scoring,
    utilization,
)
from kubernetes_autoscaler_tpu_torch.ops.kernels import wave_cases, wavefront_kernel

MAX_NEW = 16
STYLES = ["mixed", "overlap", "disjoint"]
SEEDS = [0, 1, 2, 7]
STRATEGIES = ["least-waste", "waste", "most-pods", "least-nodes", "price",
              "random"]
# the pool-partitioned world: masks overlap only within a pool
POOLED = dict(pools=4, n_pending_groups=8)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _port(tree):
    """A reference tree carried across into the port, on the CPU."""
    return from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _assert_pack_equal(ref, got):
    for name in ("placed", "scheduled", "free_after"):
        a = np.asarray(getattr(ref, name))
        b = getattr(got, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def _assert_plan_equal(ref, got):
    assert np.asarray(ref.waves).tobytes() == got.waves.numpy().tobytes()
    assert tuple(ref.waves.shape) == tuple(got.waves.shape)
    assert (ref.n_waves, ref.n_active, ref.worthwhile) == (
        got.n_waves, got.n_active, got.worthwhile)


def _wave_args(free, mask, req, count, limit_one):
    return _t(free), _t(mask), _t(req), _t(count), _t(limit_one)


# ---- the planner ----


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("seed", SEEDS)
def test_plan_matches_reference(style, seed):
    rng = np.random.default_rng(seed)
    free, mask, req, count, order, limit_one = _instance(rng, style=style)
    active = rng.random(mask.shape[0]) < 0.8
    for act in (None, active):
        assert (pack.compute_wavefronts(mask, order, act)
                == ref_pack.compute_wavefronts(mask, order, act))
        _assert_plan_equal(
            ref_pack.build_wavefront_plan(mask, order, act),
            pack.build_wavefront_plan(mask, order, act, device="cpu"))
    _assert_plan_equal(
        ref_pack.build_wavefront_plan(mask, order, pad_w=1, pad_s=1),
        pack.build_wavefront_plan(mask, order, pad_w=1, pad_s=1,
                                  device="cpu"))


def test_precedence_chain_is_not_plain_greedy():
    """Chain conflicts a↔b, b↔c (a, c disjoint): c must come after b, and
    the pack agrees with the serial pack on a contended instance."""
    n = 30
    mask = np.zeros((3, n), bool)
    mask[0, 0:10] = True
    mask[1, 5:20] = True
    mask[2, 15:25] = True
    order = np.arange(3)
    waves = pack.compute_wavefronts(mask, order)
    assert waves == ref_pack.compute_wavefronts(mask, order) == [[0], [1], [2]]
    free = np.full((n, 2), 3, np.int32)
    req = np.ones((3, 2), np.int32)
    count = np.asarray([25, 40, 28], np.int32)
    lim = np.zeros((3,), bool)
    args = _wave_args(free, mask, req, count, lim)
    got = pack.pack_groups_wavefront(
        *args, pack.build_wavefront_plan(mask, order, device="cpu"))
    serial = pack.pack_groups(args[0], args[1], args[2], args[3],
                              _t(order.astype(np.int32)), args[4])
    assert torch.equal(got.placed, serial.placed)
    _assert_pack_equal(ref_pack.pack_groups_wavefront(
        free, mask, req, count, lim,
        ref_pack.build_wavefront_plan(mask, order)), got)


def test_cache_hits_and_misses_match_reference():
    rng = np.random.default_rng(5)
    _, mask, _, _, order, _ = _instance(rng)
    mask2 = mask.copy()
    mask2[0] = ~mask2[0]                       # composition churn
    active = np.ones((mask.shape[0],), bool)
    active2 = active.copy()
    active2[3] = False
    steps = [(mask, order, None), (mask, order, None), (mask2, order, None),
             (mask2, order, active), (mask2, order, active),
             (mask2, order, active2), (mask, order[::-1].copy(), None),
             (mask, order, None)]
    ref_cache, port_cache = ref_pack.WavefrontCache(), pack.WavefrontCache()
    ref_ph, port_ph = PhaseStats(), PhaseStats()
    for m, o, a in steps:
        ref_plan = ref_cache.plan(m, o, active=a, phases=ref_ph)
        port_plan = port_cache.plan(m, o, active=a, phases=port_ph,
                                    device="cpu")
        _assert_plan_equal(ref_plan, port_plan)
        assert (ref_cache.hits, ref_cache.misses) == (port_cache.hits,
                                                      port_cache.misses)
    assert (port_cache.hits, port_cache.misses) == (2, 6)
    assert port_ph.events == ref_ph.events == {"wavefront_cache_hit": 2,
                                               "wavefront_cache_miss": 6}


def test_plan_wavefronts_matches_reference_and_hits_on_count_churn():
    ref_enc, _ = encode_world(REF, build_world(REF, **POOLED))
    port_enc, _ = encode_world(PORT, build_world(PORT, **POOLED),
                               device="cpu")
    ref_ph, port_ph = PhaseStats(), PhaseStats()
    ref_cache, port_cache = ref_pack.WavefrontCache(), pack.WavefrontCache()
    ref_plan = ref_schedule.plan_wavefronts(ref_enc.nodes, ref_enc.specs,
                                            ref_cache, phases=ref_ph)
    hostfetch.reset_round_trips()
    plan = schedule.plan_wavefronts(port_enc.nodes, port_enc.specs,
                                    port_cache, phases=port_ph)
    assert hostfetch.round_trips() == 1
    _assert_plan_equal(ref_plan, plan)
    assert plan.worthwhile and plan.n_waves < plan.n_active
    assert port_ph.events == ref_ph.events
    assert (port_ph.events["batched_fetch_bytes_logical"]
            > 4 * port_ph.events["batched_fetch_bytes_moved"])
    # every count raised by one (resident-only classes go 0 → 1): a hit
    specs2 = port_enc.specs.replace(count=port_enc.specs.count + 1)
    assert schedule.plan_wavefronts(port_enc.nodes, specs2,
                                    port_cache) is plan
    assert (port_cache.hits, port_cache.misses) == (1, 1)


# ---- the plain wavefront pack ----


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("seed", SEEDS)
def test_plain_wavefront_pack_matches_reference(style, seed):
    rng = np.random.default_rng(seed)
    for _ in range(3):
        free, mask, req, count, order, limit_one = _instance(rng, style=style)
        ref = ref_pack.pack_groups_wavefront(
            free, mask, req, count, limit_one,
            ref_pack.build_wavefront_plan(mask, order))
        args = _wave_args(free, mask, req, count, limit_one)
        got = pack.pack_groups_wavefront(
            *args, pack.build_wavefront_plan(mask, order, device="cpu"))
        _assert_pack_equal(ref, got)
        serial = pack.pack_groups(args[0], args[1], args[2], args[3],
                                  _t(order), args[4])
        for name in ("placed", "scheduled", "free_after"):
            assert torch.equal(getattr(got, name), getattr(serial, name))


def test_plain_wavefront_pack_runtime_mask_subset_of_plan_mask():
    rng = np.random.default_rng(3)
    free, plan_mask, req, count, order, limit_one = _instance(rng)
    runtime = plan_mask & (rng.random(plan_mask.shape) < 0.7)
    ref = ref_pack.pack_groups_wavefront(
        free, runtime, req, count, limit_one,
        ref_pack.build_wavefront_plan(plan_mask, order))
    args = _wave_args(free, runtime, req, count, limit_one)
    got = pack.pack_groups_wavefront(
        *args, pack.build_wavefront_plan(plan_mask, order, device="cpu"))
    _assert_pack_equal(ref, got)
    serial = pack.pack_groups(args[0], args[1], args[2], args[3], _t(order),
                              args[4])
    assert torch.equal(got.placed, serial.placed)


def test_plain_wavefront_pack_negative_counts_match_reference():
    """A negative count is no pod count, but the formula still defines the
    result (the fit is the count on every lane); the port keeps it."""
    rng = np.random.default_rng(13)
    free, mask, req, count, order, limit_one = _instance(rng, style="mixed")
    count[[1, 4, 9]] = [-3, -1, -7]
    plan_ref = ref_pack.build_wavefront_plan(mask, order)
    ref = ref_pack.pack_groups_wavefront(free, mask, req, count, limit_one,
                                         plan_ref)
    got = pack.pack_groups_wavefront(
        *_wave_args(free, mask, req, count, limit_one),
        pack.build_wavefront_plan(mask, order, device="cpu"))
    _assert_pack_equal(ref, got)
    assert (got.placed < 0).any()


def _overlapping_slot_case():
    """A hand-made plan whose wave-0 slots overlap on contended nodes: the
    segmented result (both slots read the wave-start capacity, their
    updates summed) differs from the serial one."""
    n, r = 12, 2
    free = np.full((n, r), 4, np.int32)
    mask = np.zeros((4, n), bool)
    mask[0, 0:8] = True
    mask[1, 4:12] = True                 # overlaps group 0 on lanes 4..7
    mask[2, :] = True
    mask[3, 0:3] = True
    req = np.asarray([[1, 1], [2, 1], [1, 0], [0, 0]], np.int32)
    count = np.asarray([20, 7, 5, 3], np.int32)
    limit_one = np.asarray([False, False, True, False])
    waves = np.asarray([[0, 1, -1], [2, 3, -1]], np.int32)
    return free, mask, req, count, limit_one, waves


def test_plain_wavefront_pack_keeps_segmented_semantics_on_overlapping_slots():
    free, mask, req, count, limit_one, waves = _overlapping_slot_case()
    ref = ref_pack.pack_groups_wavefront(
        free, mask, req, count, limit_one,
        ref_pack.WavefrontPlan(waves=jnp.asarray(waves), n_waves=2,
                               n_active=4))
    args = _wave_args(free, mask, req, count, limit_one)
    got = wavefront_kernel.pack_groups_wavefront(*args, _t(waves))
    _assert_pack_equal(ref, got)
    serial = pack.pack_groups(*args[:4], _t(np.arange(4, dtype=np.int32)),
                              args[4])
    assert not torch.equal(got.free_after, serial.free_after)
    assert (got.free_after < 0).any()    # the summed wave overdraws lanes


def test_plain_wavefront_pack_matches_reference_pallas_interpret():
    """The cases that run the reference Pallas kernel itself (interpret
    mode costs seconds per call): a fuzzed plan over several node tiles,
    and the overlapping-slot plan."""
    from kubernetes_autoscaler_tpu.ops.pallas.pack_kernel import (
        pack_groups_wavefront_pallas,
    )

    rng = np.random.default_rng(21)
    free, mask, req, count, order, limit_one = _instance(rng, n=300, g=10,
                                                         style="mixed")
    plan = ref_pack.build_wavefront_plan(mask, order)
    ref = pack_groups_wavefront_pallas(free, mask, req, count, limit_one,
                                       plan, tile=128, interpret=True)
    got = pack.pack_groups_wavefront(
        *_wave_args(free, mask, req, count, limit_one),
        pack.build_wavefront_plan(mask, order, device="cpu"))
    _assert_pack_equal(ref, got)

    free, mask, req, count, limit_one, waves = _overlapping_slot_case()
    ref = pack_groups_wavefront_pallas(
        free, mask, req, count, limit_one,
        ref_pack.WavefrontPlan(waves=jnp.asarray(waves), n_waves=2,
                               n_active=4),
        tile=128, interpret=True)
    got = wavefront_kernel.pack_groups_wavefront(
        *_wave_args(free, mask, req, count, limit_one), _t(waves))
    _assert_pack_equal(ref, got)


def test_wavefront_wrapper_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(4)
    free, mask, req, count, order, limit_one = _instance(rng, g=6)
    args = _wave_args(free, mask, req, count, limit_one)
    waves = pack.build_wavefront_plan(mask, order, device="cpu").waves
    bad = waves.clone()
    bad[0, 0] = 6                                    # G = 6: out of range
    with pytest.raises(ValueError, match="group ids"):
        wavefront_kernel.pack_groups_wavefront(*args, bad)
    bad[0, 0] = -2
    with pytest.raises(ValueError, match="group ids"):
        wavefront_kernel.pack_groups_wavefront(*args, bad)
    twice = torch.tensor([[0, 1], [1, -1]], dtype=torch.int32)
    with pytest.raises(ValueError, match="more than one slot"):
        wavefront_kernel.pack_groups_wavefront(*args, twice)
    with pytest.raises(ValueError, match="contiguous"):
        wavefront_kernel.pack_groups_wavefront(
            args[0], args[1].T.contiguous().T, *args[2:], waves)
    with pytest.raises(TypeError):
        wavefront_kernel.pack_groups_wavefront(*args, waves.long())
    # the ids are checked once per tensor version: an in-place edit of a
    # checked plan is read again
    ok = waves.clone()
    wavefront_kernel.pack_groups_wavefront(*args, ok)
    ok[0, 0] = 6
    with pytest.raises(ValueError, match="group ids"):
        wavefront_kernel.pack_groups_wavefront(*args, ok)


@pytest.mark.parametrize("name", list(wave_cases.CASES))
def test_wave_case_plain_matches_reference(name):
    """Every case of the list the card holds K2 to: the port's plain
    version (what the wrapper takes on CPU tensors) against the JAX
    package's XLA pack_groups_wavefront, byte for byte."""
    args = wave_cases.CASES[name]()
    waves = args[5]
    ref = ref_pack.pack_groups_wavefront(
        *[a.numpy() for a in args[:5]],
        ref_pack.WavefrontPlan(waves=jnp.asarray(waves.numpy()),
                               n_waves=waves.shape[0], n_active=1))
    _assert_pack_equal(ref, wavefront_kernel.pack_groups_wavefront(*args))


def test_wavefront_wrapper_dispatches_on_the_tensors_device(monkeypatch):
    """CPU tensors take the plain version and never reach the kernel; a
    device with no kernel raises instead of falling back."""
    def no_kernel(*a, **k):
        raise AssertionError("the kernel was reached with CPU tensors")

    args = wave_cases.CASES["negative counts"]()
    monkeypatch.setattr(wavefront_kernel, "launch", no_kernel)
    monkeypatch.setattr(wavefront_kernel, "_entry", no_kernel)
    before = wavefront_kernel.pack_groups_wavefront.launches
    got = wavefront_kernel.pack_groups_wavefront(*args)
    want = wavefront_kernel.pack_groups_wavefront_plain(*args)
    for name in ("placed", "scheduled", "free_after"):
        assert torch.equal(getattr(got, name), getattr(want, name))
    assert wavefront_kernel.pack_groups_wavefront.launches == before
    monkeypatch.setattr(wavefront_kernel, "_check_waves", lambda w, g: None)
    with pytest.raises(ValueError, match="no kernel for meta"):
        wavefront_kernel.pack_groups_wavefront(*[a.to("meta") for a in args])


# ---- host fetch and bit packing ----


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 100])
def test_pack_flat_bits_matches_reference(n):
    rng = np.random.default_rng(n)
    flat = rng.random(n) < 0.5
    if n >= 32:
        flat[31] = True                            # the sign bit
    ref = np.asarray(ref_bits.pack_flat_bits(jnp.asarray(flat)))
    got = bitplane.pack_flat_bits(_t(flat)).numpy()
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
    back = bitplane.unpack_flat_bits_np(got, n)
    assert back.tobytes() == ref_bits.unpack_flat_bits_np(ref, n).tobytes()
    assert (back == flat).all()


def _mixed_tree(seed):
    rng = np.random.default_rng(seed)
    return (rng.random((5, 37)) < 0.5,
            rng.integers(-9, 9, (4, 3)).astype(np.int32),
            rng.random(6).astype(np.float32),
            rng.random(40) < 0.3,
            rng.integers(0, 200, (7,)).astype(np.uint8),
            rng.integers(-300, 300, (2, 2)).astype(np.int16),
            np.asarray(True))


def test_fetch_pytree_matches_reference():
    tree = _mixed_tree(0)
    ref_ph, port_ph = PhaseStats(), PhaseStats()
    ref_fetch.reset_round_trips()
    hostfetch.reset_round_trips()
    ref = ref_fetch.fetch_pytree(tuple(jnp.asarray(x) for x in tree),
                                 phases=ref_ph)
    got = hostfetch.fetch_pytree(tuple(_t(x) for x in tree), phases=port_ph)
    assert hostfetch.round_trips() == ref_fetch.round_trips() == 1
    assert port_ph.events == ref_ph.events
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_fetch_pytree_keeps_structure_and_counts_round_trips():
    enc, _ = encode_world(PORT, build_world(PORT, n_nodes=6), device="cpu")
    tree = {"b": enc.nodes, "a": [enc.specs.count, (enc.specs.valid,)],
            "plan": pack.build_wavefront_plan(
                np.ones((2, 3), bool), np.arange(2), device="cpu")}
    hostfetch.reset_round_trips()
    got = hostfetch.fetch_pytree(tree)
    assert hostfetch.round_trips() == 1
    assert list(got) == ["b", "a", "plan"]
    assert type(got["b"]) is type(enc.nodes)
    assert got["plan"].n_waves == 2 and got["plan"].n_active == 2
    assert isinstance(got["a"], list) and isinstance(got["a"][1], tuple)
    for key in tree:
        assert_trees_equal(tree[key], got[key])
    # host leaves: no transfer; one leaf: one copy, no accounting
    ph = PhaseStats()
    assert hostfetch.fetch_pytree(got, phases=ph) is got
    one = hostfetch.fetch_pytree((enc.specs.count,), phases=ph)
    assert one[0].tobytes() == enc.specs.count.numpy().tobytes()
    with hostfetch.suppress_counting():
        hostfetch.fetch_pytree((enc.specs.count, enc.specs.valid))
    assert hostfetch.round_trips() == 2 and ph.events == {}
    with pytest.raises(TypeError, match="cannot pack"):
        hostfetch.fetch_pytree((enc.specs.count, enc.specs.count.long()))


def test_from_numpy_carries_a_wavefront_plan():
    rng = np.random.default_rng(8)
    _, mask, _, _, order, _ = _instance(rng, style="disjoint")
    ref = ref_pack.build_wavefront_plan(mask, order)
    got = from_numpy(jax.tree.map(np.asarray, ref), device="cpu")
    assert type(got) is pack.WavefrontPlan
    assert got.waves.dtype == torch.int32
    assert isinstance(got.n_waves, int) and isinstance(got.n_active, int)
    _assert_plan_equal(ref, got)


# ---- scoring and utilization ----


def test_best_option_matches_reference_for_every_strategy():
    rng = np.random.default_rng(2)
    ng = 9
    valid = rng.random(ng) < 0.6
    valid[[2, 5]] = True
    pods = rng.integers(0, 4, ng).astype(np.int32)
    nodes = rng.integers(0, 3, ng).astype(np.int32)
    waste = rng.choice([0.25, 0.5, 0.75], ng).astype(np.float32)
    price = rng.choice([1.0, 2.0], ng).astype(np.float32)
    ref = ref_scoring.OptionScores(
        valid=jnp.asarray(valid), pods=jnp.asarray(pods),
        nodes=jnp.asarray(nodes), waste=jnp.asarray(waste),
        price=jnp.asarray(price))
    got = scoring.OptionScores(valid=_t(valid), pods=_t(pods),
                               nodes=_t(nodes), waste=_t(waste),
                               price=_t(price))
    none = got.replace(valid=torch.zeros((ng,), dtype=torch.bool))
    for strategy in STRATEGIES:
        want = np.asarray(ref_scoring.best_option(ref, strategy))
        best = scoring.best_option(got, strategy)
        assert best.dtype == torch.int32 and best.shape == ()
        assert int(best) == int(want)
        assert bool(valid[int(best)])
        assert int(scoring.best_option(none, strategy)) == -1
    with pytest.raises(ValueError, match="unknown expander strategy"):
        scoring.best_option(got, "fastest")


def test_eligible_for_scale_down_matches_reference():
    ref_enc, _ = encode_world(REF, build_world(REF, seed=3))
    nodes = _port(ref_enc.nodes)
    n = ref_enc.nodes.n
    per_node = np.linspace(0.05, 0.95, n).astype(np.float32)
    for thr_ref, thr in ((0.5, 0.5), (0.0, 0.0),
                         (jnp.asarray(per_node), _t(per_node))):
        ref = np.asarray(ref_util.eligible_for_scale_down(ref_enc.nodes,
                                                          thr_ref))
        got = utilization.eligible_for_scale_down(nodes, thr).numpy()
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


# ---- the phased sims ----


def _both_worlds(**kw):
    ref_enc, ref_groups = encode_world(REF, build_world(REF, **kw))
    port_enc, port_groups = encode_world(PORT, build_world(PORT, **kw),
                                         device="cpu")
    return ref_enc, ref_groups, port_enc, port_groups


def _check_sims(ref, got):
    assert_trees_equal(ref, got, float_rtol=1e-6)
    a, b = leaves(ref), leaves(got)
    best = [p for p in a if p.endswith(".best")]
    for p in best:
        assert int(a[p]) == int(b[p])


@pytest.mark.parametrize("plan_from", ["reference via from_numpy", "port"])
def test_scale_up_sim_with_a_worthwhile_plan_matches_reference(plan_from,
                                                              monkeypatch):
    ref_enc, ref_groups, port_enc, port_groups = _both_worlds(**POOLED)
    ref_plan = ref_schedule.plan_wavefronts(ref_enc.nodes, ref_enc.specs,
                                            ref_pack.WavefrontCache())
    if plan_from == "port":
        plan = schedule.plan_wavefronts(port_enc.nodes, port_enc.specs,
                                        pack.WavefrontCache())
    else:
        plan = from_numpy(jax.tree.map(np.asarray, ref_plan), device="cpu")
    _assert_plan_equal(ref_plan, plan)
    assert plan.worthwhile
    # the superset contract is exercised: a resident sibling of a
    # self-anti-affinity group takes lanes off the runtime mask
    _, runtime, *_ = schedule.filter_pack_inputs(
        port_enc.nodes, port_enc.specs, port_enc.scheduled)
    plan_mask = schedule.predicates.feasibility_mask(
        port_enc.nodes, port_enc.specs, check_resources=False)
    assert bool((runtime <= plan_mask).all())
    assert not torch.equal(runtime, plan_mask)

    calls = []
    plain = wavefront_kernel.pack_groups_wavefront_plain
    monkeypatch.setattr(wavefront_kernel, "pack_groups_wavefront_plain",
                        lambda *a: calls.append(1) or plain(*a))
    ref = ref_step.scale_up_sim(
        ref_enc.nodes, ref_enc.specs, ref_enc.scheduled, ref_groups,
        RefDims(), MAX_NEW, "least-waste", wavefront_plan=ref_plan)
    got = port_step.scale_up_sim(
        port_enc.nodes, port_enc.specs, port_enc.scheduled, port_groups,
        Dims(), MAX_NEW, "least-waste", wavefront_plan=plan)
    assert calls == [1]                       # the wavefront pack ran
    _check_sims(ref, got)
    serial = port_step.scale_up_sim(
        port_enc.nodes, port_enc.specs, port_enc.scheduled, port_groups,
        Dims(), MAX_NEW, "least-waste")
    assert calls == [1]
    assert_trees_equal(got, serial)
    dec = leaves(ref)
    assert dec[".fits_existing"].sum() > 0 and dec[".remaining"].sum() > 0
    assert int(dec[".best"]) >= 0


@pytest.mark.parametrize("seed", [0, 1])
def test_scale_up_sim_without_a_plan_matches_reference(seed):
    ref_enc, ref_groups, port_enc, port_groups = _both_worlds(seed=seed)
    for strategy in ("least-waste", "most-pods"):
        ref = ref_step.scale_up_sim(
            ref_enc.nodes, ref_enc.specs, ref_enc.scheduled, ref_groups,
            RefDims(), MAX_NEW, strategy)
        got = port_step.scale_up_sim(
            port_enc.nodes, port_enc.specs, port_enc.scheduled, port_groups,
            Dims(), MAX_NEW, strategy)
        _check_sims(ref, got)
    # an overlap-heavy world: the plan is not worthwhile and the serial
    # pack runs, with the same result
    plan = schedule.plan_wavefronts(port_enc.nodes, port_enc.specs,
                                    pack.WavefrontCache())
    assert not plan.worthwhile
    assert_trees_equal(got, port_step.scale_up_sim(
        port_enc.nodes, port_enc.specs, port_enc.scheduled, port_groups,
        Dims(), MAX_NEW, "most-pods", wavefront_plan=plan))


@pytest.mark.parametrize("world", [dict(seed=0), dict(seed=1), POOLED])
def test_scale_down_sim_matches_reference(world):
    ref_enc, _, port_enc, _ = _both_worlds(**world)
    ref = ref_step.scale_down_sim(ref_enc.nodes, ref_enc.specs,
                                  ref_enc.scheduled, 0.5, 16, 8)
    got = port_step.scale_down_sim(port_enc.nodes, port_enc.specs,
                                   port_enc.scheduled, 0.5, 16)
    _check_sims(ref, got)
    dec = leaves(ref)
    assert dec[".eligible"].any()
    assert dec[".removal.drainable"].any()
    assert dec[".removal.has_blocker"].any()


@pytest.mark.parametrize("world", [dict(seed=2), POOLED])
def test_run_once_sim_matches_reference(world):
    ref_enc, ref_groups, port_enc, port_groups = _both_worlds(**world)
    ref = ref_step.run_once_sim(
        RefClusterTensors(nodes=ref_enc.nodes, pending=ref_enc.specs,
                          scheduled=ref_enc.scheduled, groups=ref_groups),
        RefDims(), max_new_nodes=MAX_NEW, strategy="least-nodes",
        threshold=0.6, max_pods_per_node=16)
    got = port_step.run_once_sim(
        ClusterTensors(nodes=port_enc.nodes, pending=port_enc.specs,
                       scheduled=port_enc.scheduled, groups=port_groups),
        Dims(), max_new_nodes=MAX_NEW, strategy="least-nodes",
        threshold=0.6, max_pods_per_node=16)
    _check_sims(ref, got)

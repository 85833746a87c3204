"""The topology-aware drain sweep's plain version (ops/kernels/drain_kernel.py
with TopoInputs), through the port's `drain.simulate_removals(...,
with_constraints=True)`, against the JAX package's, on the CPU.

Every case of `ops/kernels/drain_topo_cases.CASES` (numpy inputs from a
seed, at small widths) goes through both packages on the same world. Every
leaf is compared by dtype, shape and bytes, with no tolerance: the sweep is
int32 and bool throughout. The chunk of candidates changes the plain
version's memory only, so each case runs at chunks of 1 and 5 and at the
default. The same cases hold the CUDA kernel's topology mode to the plain
version on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_trees_equal

from kubernetes_autoscaler_tpu.models import cluster_state as ref_cs
from kubernetes_autoscaler_tpu.ops import drain as ref_drain
from kubernetes_autoscaler_tpu_torch.ops import drain
from kubernetes_autoscaler_tpu_torch.ops.kernels import (
    constrained_kernel,
    drain_kernel,
    drain_topo_cases,
)

REF_CHUNK = 64   # every case has 48 candidates: one reference shape
CASES = drain_topo_cases.CASES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny inputs: one intra-op thread keeps this file off the other test
    workers' cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ref(tree):
    """A port tensor tree as the reference's tree of the same name."""
    cls = getattr(ref_cs, type(tree).__name__)
    return cls(**{k: None if v is None else jnp.asarray(v.numpy())
                  for k, v in vars(tree).items()})


def _kw(case, chunk):
    return dict(max_pods_per_node=case.max_pods_per_node, chunk=chunk,
                max_groups_per_node=case.max_groups_per_node,
                max_zones=case.max_zones, with_constraints=True)


@functools.cache
def _reference(name: str):
    """The JAX package's RemovalResult of the case, as numpy leaves by name
    beside the result itself."""
    case = CASES[name]()
    res = ref_drain.simulate_removals(
        _ref(case.nodes), _ref(case.specs), _ref(case.scheduled),
        jnp.asarray(case.candidates.numpy()),
        jnp.asarray(case.dest_allowed.numpy()), planes=_ref(case.planes),
        **_kw(case, REF_CHUNK))
    return res, {k: np.asarray(v) for k, v in vars(res).items()}


@pytest.mark.parametrize("chunk", [1, 5, None])
@pytest.mark.parametrize("name", list(CASES))
def test_topo_sweep_matches_reference(name, chunk):
    case = CASES[name]()
    ref, _ = _reference(name)
    launches = (drain_kernel.launch.launches,
                constrained_kernel.launch.launches)
    lanes = drain_kernel.sweep_plain.active_lanes
    got = drain.simulate_removals(
        case.nodes, case.specs, case.scheduled, case.candidates,
        case.dest_allowed, planes=case.planes, **_kw(case, chunk))
    assert_trees_equal(ref, got)
    # the CPU runs no kernel; some (candidate, slot) lanes re-placed by waves
    assert (drain_kernel.launch.launches,
            constrained_kernel.launch.launches) == launches
    assert drain_kernel.sweep_plain.active_lanes > lanes


def test_topo_active_lanes_count_real_candidates_only():
    """The plain version's count of waved lanes is the same at every chunk:
    the padding of the last chunk counts for nothing."""
    case = CASES["zone_anti_self"]()
    inp, topo = case.inputs()
    counts = []
    for chunk in (5, None):      # 48 candidates: the chunks of 5 pad to 50
        before = drain_kernel.sweep_plain.active_lanes
        drain_kernel.sweep_plain(inp, case.max_groups_per_node, False,
                                 chunk=chunk, topo=topo)
        counts.append(drain_kernel.sweep_plain.active_lanes - before)
    assert counts[0] == counts[1] > 0


def _dests(case, rem, c, group):
    """Destinations of candidate c's pods of `group` (-1: not placed)."""
    pods = rem["pod_slot"][c]
    on = (pods >= 0) & (case.scheduled.group_ref.numpy()[np.maximum(pods, 0)]
                        == group)
    return rem["dest_node"][c][on]


def test_topo_cases_reach_their_edges():
    """Each case pins what its name says, in the reference's own results."""
    def run(name):
        return CASES[name](), _reference(name)[1]

    case, rem = run("host_spread")
    zone = case.nodes.zone_id.numpy()
    for c in (4, 9):
        d = _dests(case, rem, c, 2)
        assert (d >= 0).all() and len(set(d.tolist())) == d.size == 6

    case, rem = run("zone_spread_self")
    d = _dests(case, rem, 5, 3)
    assert (d >= 0).any() and len(set(zone[d[d >= 0]].tolist())) >= 2

    case, rem = run("zone_anti_self")
    d = _dests(case, rem, 10, 4)
    zoned = zone[d[d >= 0]]
    zoned = zoned[zoned > 0]
    assert d.size == 2 and len(set(zoned.tolist())) == zoned.size

    case, rem = run("affinity")
    zone = case.nodes.zone_id.numpy()
    for c in (2, 11):
        host = _dests(case, rem, c, 5)
        assert (host >= 0).all() and len(set(host.tolist())) == 1
        z8 = _dests(case, rem, c, 8)
        assert (z8 >= 0).all() and len(set(zone[z8].tolist())) == 1
        z6 = _dests(case, rem, c, 6)
        assert (z6 >= 0).all() and (zone[z6] == 3).all()
        h10 = _dests(case, rem, c, 10)
        assert set(h10.tolist()) <= {14, 20} and (h10 >= 0).all()

    case, rem = run("ghost_node")
    zone = case.nodes.zone_id.numpy()
    for c, group in ((0, 9), (1, 9), (2, 9), (4, 10)):
        d = _dests(case, rem, c, group)
        assert d.size == 1 and d[0] >= 0 and zone[d[0]] == zone[c]

    case, rem = run("limit_one_spread")
    d = _dests(case, rem, 8, 1)
    assert (d >= 0).all() and len(set(d.tolist())) == 5

    case, rem = run("max_waves")
    d = _dests(case, rem, 3, 0)
    assert d.size == 140 and (d >= 0).sum() == 128
    assert not rem["drainable"][3]

    case, rem = run("beyond_k")
    for c in (6, 13):
        assert (_dests(case, rem, c, 8) == -1).all()
        assert (_dests(case, rem, c, 10) == -1).all()
        assert not rem["drainable"][c]

    case, rem = run("mixed_slots")
    for c in (15, 16):
        for group in (1, 2, 3, 6):
            assert (_dests(case, rem, c, group) >= 0).all()

    case, rem = run("negative_free")
    free = (case.nodes.cap - case.nodes.alloc).numpy()
    over = (free < 0).any(axis=1)
    assert over.any()
    for c in (9, 21):
        d = _dests(case, rem, c, 2)
        assert (d >= 0).any() and not over[d[d >= 0]].any()

    case, rem = run("every_kind")
    s = case.specs
    kinds = {int(k) for k in s.spread_kind.numpy()} | \
        {10 + int(k) for k in s.aff_kind.numpy()}
    assert {0, 1, 2, 11, 12} <= kinds and s.anti_self_zone.any()
    assert rem["drainable"].any() and not rem["drainable"].all()


def test_topo_wrapper_rejects_what_the_kernel_does_not_take():
    """The topology inputs' contract holds on the CPU too."""
    case = CASES["mixed_slots"]()
    inp, topo = case.inputs()
    f = drain_kernel.sweep
    with pytest.raises(TypeError):
        f(inp, 4, False, topo=topo.replace(spread_cnt=topo.spread_cnt.long()))
    with pytest.raises(TypeError):
        f(inp, 4, False, topo=topo.replace(s_elig=topo.s_elig.to(torch.int32)))
    with pytest.raises(ValueError):
        f(inp, 4, False, topo=topo.replace(zone_cl=topo.zone_cl[:-1]))
    with pytest.raises(ValueError):
        f(inp, 4, False, topo=topo.replace(cnt_zone=topo.cnt_zone[:, :-1]))
    with pytest.raises(ValueError):
        f(inp, 4, False,
          topo=topo.replace(aff_cnt=topo.aff_cnt.t().contiguous().t()))
    with pytest.raises(ValueError):
        f(inp, 4, False, topo=topo.replace(anti_zone=topo.anti_zone[:, :0],
                                           aff_zone=topo.aff_zone[:, :0],
                                           cnt_zone=topo.cnt_zone[:, :0],
                                           elig_zone=topo.elig_zone[:, :0]))

"""The drain sweep's plain version (ops/kernels/drain_kernel.py), through
the port's `drain.simulate_removals` and `drain.failure_reasons`, against
the JAX package's, on the CPU.

Every case of `ops/kernels/drain_cases.CASES` (numpy inputs from a seed, at
small widths) goes through both packages on the same world. Every leaf is
compared by dtype, shape and bytes, with no tolerance: the sweep is int32
and bool throughout. The chunk of candidates changes the plain version's
memory only, so each case runs at chunks of 1 and 5 and at the default.
The same cases hold the CUDA kernel to the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).

Also here: the wrapper's input contract, which holds on either device, and
the empty candidate list.
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
from kubernetes_autoscaler_tpu_torch.ops.kernels import drain_cases, drain_kernel

REF_CHUNK = 64   # every case has at most 64 candidates: one reference shape


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


def _args(case, candidates=None):
    cand = case.candidates if candidates is None else candidates
    return (case.nodes, case.specs, case.scheduled, cand, case.dest_allowed)


def _kw(case, chunk):
    return dict(max_pods_per_node=case.max_pods_per_node, chunk=chunk,
                max_groups_per_node=case.max_groups_per_node)


def _ref_args(case, candidates=None):
    nodes, specs, sched, cand, dest = _args(case, candidates)
    return (_ref(nodes), _ref(specs), _ref(sched), jnp.asarray(cand.numpy()),
            jnp.asarray(dest.numpy()))


@functools.cache
def _reference(name: str):
    """(RemovalResult, RemovalReasons) of the case from the JAX package."""
    case = drain_cases.CASES[name]()
    args, kw = _ref_args(case), _kw(case, REF_CHUNK)
    return (ref_drain.simulate_removals(*args, **kw),
            ref_drain.failure_reasons(*args, **kw))


@pytest.mark.parametrize("chunk", [1, 5, None])
@pytest.mark.parametrize("name", list(drain_cases.CASES))
def test_sweep_matches_reference(name, chunk):
    case = drain_cases.CASES[name]()
    ref_rem, ref_why = _reference(name)
    before = drain_kernel.launch.launches
    got = drain.simulate_removals(*_args(case), **_kw(case, chunk))
    assert_trees_equal(ref_rem, got)
    why = drain.failure_reasons(*_args(case), **_kw(case, chunk))
    assert_trees_equal(ref_why, why)
    assert drain_kernel.launch.launches == before   # the CPU runs no kernel


def test_cases_reach_their_edges():
    """Each case pins what its name says, in the reference's own results."""
    def run(name):
        case = drain_cases.CASES[name]()
        rem, why = _reference(name)
        return (case, {k: np.asarray(v) for k, v in vars(rem).items()},
                {k: np.asarray(v) for k, v in vars(why).items()})

    case, rem, why = run("empty_node")
    assert rem["drainable"][[0, 5, 36]].all()
    assert (rem["pod_slot"][[0, 5, 36]] == -1).all()
    case, rem, why = run("blocker")
    assert rem["has_blocker"][[4, 9]].all()
    assert (why["reason"][[4, 9]] == drain.DRAIN_BLOCKED_BY_POD).all()
    case, rem, why = run("too_many_shapes")
    assert (why["reason"][[6, 7]] == drain.DRAIN_TOO_MANY_SHAPES).all()
    assert (rem["n_failed"][[6, 7]] >= 3).all()
    case, rem, why = run("limit_one")
    dests = rem["dest_node"][10][rem["dest_node"][10] >= 0]
    assert dests.size == 12
    for g in (2, 3):
        pods = rem["pod_slot"][10]
        on_g = (pods >= 0) & (case.scheduled.group_ref.numpy()[pods] == g)
        d = rem["dest_node"][10][on_g]
        assert (d >= 0).all() and len(set(d.tolist())) == d.size
    case, rem, why = run("zero_request")
    assert rem["drainable"][3]
    case, rem, why = run("negative_free")
    assert (why["reason"] == drain.DRAIN_NO_PLACE_FOR_GROUP).any()
    case, rem, why = run("no_destination")
    assert (rem["dest_node"] == -1).all() and not rem["n_moved"].any()
    case, rem, why = run("spill")
    assert len(set(rem["dest_node"][20][rem["dest_node"][20] >= 0])) >= 8
    case, rem, why = run("full_window")
    assert (rem["pod_slot"][[2, 3]] >= 0).all()
    case, rem, why = run("reverse_subset")
    assert case.candidates.numpy()[0] == drain_cases.N - 1
    case, rem, why = run("wide")
    assert (rem["dest_node"] >= 1024).any()
    assert (why["reason"] == drain.DRAIN_NO_PLACE_FOR_GROUP).any()


def test_fit_plane_cases_reach_their_edges():
    """The cases for the kernel's fit plane (a u16 capped at MPN) pin their
    edges in the reference's own results: fits past MPN on every node (a
    node takes several of a candidate's pods), limit_one beside that cap
    (one a node), and a candidate whose debit rows fall in every tile of
    2,048 nodes, the later slot placing there."""
    def run(name):
        case = drain_cases.CASES[name]()
        rem, _ = _reference(name)
        return case, {k: np.asarray(v) for k, v in vars(rem).items()}

    case, rem = run("over_mpn")
    free = (case.nodes.cap - case.nodes.alloc).numpy()
    assert (free // case.specs.req.numpy().max() > drain_cases.MPN).all()
    dests = rem["dest_node"][rem["dest_node"] >= 0]
    assert dests.size and np.bincount(dests).max() > 1
    assert rem["drainable"].any()
    case, rem = run("limit_one_cap")
    pods = rem["pod_slot"][9]
    on_2 = (pods >= 0) & (case.scheduled.group_ref.numpy()[pods] == 2)
    d = rem["dest_node"][9][on_2]
    assert d.size == 9 and (d >= 0).all() and len(set(d.tolist())) == 9
    case, rem = run("debits_every_tile")
    tiles = 2048
    for k in range(4):                    # the four candidates holding pods
        d = rem["dest_node"][k]
        assert sorted(set((d[d >= 0] // tiles).tolist())) == [0, 1, 2]
        assert rem["drainable"][k] and rem["n_moved"][k] == 6


def test_no_candidates_match_reference():
    case = drain_cases.CASES["mixed"]()
    none = torch.zeros((0,), dtype=torch.int32)
    args, kw = _ref_args(case, none), _kw(case, REF_CHUNK)
    assert_trees_equal(ref_drain.simulate_removals(*args, **kw),
                       drain.simulate_removals(*_args(case, none),
                                               **_kw(case, None)))
    assert_trees_equal(ref_drain.failure_reasons(*args, **kw),
                       drain.failure_reasons(*_args(case, none),
                                             **_kw(case, None)))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """The input contract holds on the CPU too."""
    case = drain_cases.CASES["mixed"]()
    inp = case.inputs()
    f = drain_kernel.sweep
    with pytest.raises(TypeError):
        f(inp.replace(free=inp.free.long()), 4, False)
    with pytest.raises(TypeError):
        f(inp.replace(movable=inp.movable.to(torch.uint8)), 4, False)
    with pytest.raises(ValueError):
        f(inp.replace(feas=inp.feas[:, :-1]), 4, False)
    with pytest.raises(ValueError):
        f(inp.replace(starts=inp.starts[:-1]), 4, False)
    with pytest.raises(ValueError):
        f(inp.replace(req=inp.req.t().contiguous().t()), 4, False)
    with pytest.raises(ValueError):
        f(inp.replace(pad_order=inp.pad_order[:inp.node_idx.shape[0]]), 4,
          False)
    with pytest.raises(ValueError):
        f(inp, 0, False)
    with pytest.raises(ValueError):
        f(inp.replace(free=inp.free[:, None, :]), 4, False)

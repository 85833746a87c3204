"""The predicate plane's plain version (ops/kernels/predicate_kernel.py),
through every public tensor function of the port's `ops/predicates.py`,
against the JAX package's, on the CPU.

Every case of `ops/kernels/pred_cases.CASES` (numpy hash planes from a seed,
at small widths and at the default `Dims()` widths) goes through both
packages: `feasibility_mask` and `reason_mask` with and without resources,
`reason_mask_for_groups` with the case's group mask, `selector_match`,
`taints_tolerated`, `ports_free`, `resources_fit`. Outputs are compared by
dtype, shape and bytes, with no tolerance (bool and uint16). The same cases
hold the CUDA kernel to the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).

Also here: `feasibility_mask == (reason_mask == 0)` on the port, every
refusal bit reached by some case, one wrapper call for each public function
and 3 (7 with constraints) a fused step, and the wrapper's input contract,
which holds on either device.

The resident self-anti-affinity term: the plane with each case's resident
pods equals the reference's `feasibility_mask & ~(anti_affinity_self &
(resident_group_counts > 0))` byte for byte, and so do `filter_pack_inputs`'
mask and `sweep_inputs`' plane; `resident_group_counts` reads indices
outside the plane as the reference's `.at[]` does.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import build_world, encode_world

from kubernetes_autoscaler_tpu.models import cluster_state as ref_cs
from kubernetes_autoscaler_tpu.ops import predicates as ref_preds
from kubernetes_autoscaler_tpu.ops import schedule as ref_schedule
from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    Dims,
    ScheduledPodTensors,
)
from kubernetes_autoscaler_tpu_torch.ops import (
    autoscale_step,
    drain,
    predicates,
    schedule,
)
from kubernetes_autoscaler_tpu_torch.ops.kernels import pred_cases
from kubernetes_autoscaler_tpu_torch.ops.kernels import predicate_kernel as pk

PORT = "kubernetes_autoscaler_tpu_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny inputs: one intra-op thread keeps this file off the other test
    workers' cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.cache
def _case(name: str) -> pred_cases.Case:
    return pred_cases.CASES[name]()


def _ref(tree):
    """A port tensor tree as the reference's tree of the same name."""
    cls = getattr(ref_cs, type(tree).__name__)
    return cls(**{k: None if v is None else jnp.asarray(v.numpy())
                  for k, v in vars(tree).items()})


@pytest.mark.parametrize("func", list(pred_cases.FUNCTIONS))
@pytest.mark.parametrize("name", list(pred_cases.CASES))
def test_plane_matches_reference(name, func):
    case = _case(name)
    got = pred_cases.public(func, predicates, case.nodes, case.specs,
                            case.group_mask)
    ref = np.asarray(pred_cases.public(
        func, ref_preds, _ref(case.nodes), _ref(case.specs),
        jnp.asarray(case.group_mask.numpy())))
    got_np = got.numpy()
    assert got_np.dtype == ref.dtype, (got_np.dtype, ref.dtype)
    assert got_np.shape == ref.shape == (case.specs.g, case.nodes.n)
    assert got_np.tobytes() == ref.tobytes()
    # the public function is the wrapper on the arguments plane_args names
    assert torch.equal(got, pk.plane_plain(*pred_cases.plane_args(func, case)))


@pytest.mark.parametrize("name", list(pred_cases.CASES))
def test_feasible_iff_no_refusal_bit(name):
    case = _case(name)
    nodes, specs, mask = case.nodes, case.specs, case.group_mask
    for res in (False, True):
        feas = predicates.feasibility_mask(nodes, specs, check_resources=res)
        bits = predicates.reason_mask(nodes, specs, check_resources=res)
        assert torch.equal(feas, bits == 0)
        assert torch.equal(
            predicates.reason_mask_for_groups(nodes, specs, mask,
                                              check_resources=res),
            torch.where(mask[:, None], bits, 0))
        checks = pk.STATIC | (pk.RESOURCES if res else 0)
        assert torch.equal(pk.plane(nodes, specs, checks, group_mask=mask),
                           feas & mask[:, None])
    # the full plane is the AND of its single checks
    assert torch.equal(
        predicates.feasibility_mask(nodes, specs),
        predicates.selector_match(nodes.label_hash, specs)
        & predicates.taints_tolerated(nodes.taint_exact, nodes.taint_key,
                                      specs)
        & predicates.ports_free(nodes.used_ports, specs)
        & predicates.resources_fit(nodes, specs)
        & (nodes.valid & nodes.ready & nodes.schedulable)[None, :]
        & specs.valid[:, None])


def test_cases_reach_every_refusal_bit():
    """Between them the cases set every REASON bit, and every case has
    both feasible and refused pairs."""
    seen = 0
    for name in pred_cases.CASES:
        case = _case(name)
        bits = predicates.reason_mask(case.nodes, case.specs).to(torch.int32)
        assert (bits == 0).any() and (bits != 0).any(), name
        for bit, _ in predicates.REASON_BITS:
            if ((bits & bit) != 0).any():
                seen |= bit
    missing = [n for b, n in predicates.REASON_BITS if not seen & b]
    assert not missing, missing


def test_wrap_case_wraps():
    """The "wrap" case's free capacity is past int32: the plane reads it
    wrapped, as NodeTensors.free computes it."""
    n = _case("wrap").nodes
    wide = n.cap.long() - n.alloc.long()
    assert (wide != n.free().long()).any()
    assert (wide > 2 ** 31 - 1).any() and (wide < -2 ** 31).any()


@pytest.fixture
def plane_calls(monkeypatch):
    """The checks of every predicate_kernel.plane call made under it, with
    "+residents" where the call passed the resident pods."""
    calls = []
    real = pk.plane

    def plane(*a, **kw):
        _, _, checks, _, _, scheduled = pk.bind_args(*a, **kw)
        calls.append(checks if scheduled is None else f"{checks}+residents")
        return real(*a, **kw)

    monkeypatch.setattr(pk, "plane", plane)
    return calls


@pytest.mark.parametrize("func", list(pred_cases.FUNCTIONS))
def test_public_function_is_one_wrapper_call(func, plane_calls):
    case = _case("random")
    pred_cases.public(func, predicates, case.nodes, case.specs,
                      case.group_mask)
    assert plane_calls == [pred_cases.plane_args(func, case)[2]]


@pytest.mark.parametrize("with_constraints", [False, True])
def test_fused_step_plane_calls(with_constraints, plane_calls):
    """The fused step builds its planes through the wrapper: the filter,
    the templates and the drain's preparation (3; the filter's and the
    drain's with the resident pods), and with constraints four more
    selector planes (the options' and the filter's constraint state, the
    drain's topology inputs): one call each on the card."""
    enc, groups = encode_world(PORT, build_world(PORT, seed=0), device="cpu")
    autoscale_step.run_once_fused(
        enc.nodes, enc.specs, enc.scheduled, groups,
        torch.full((groups.ng,), 16, dtype=torch.int32), Dims(),
        max_new_nodes=16, max_pods_per_node=32, planes=enc.planes,
        with_constraints=with_constraints)
    static, res = pk.STATIC, f"{pk.STATIC}+residents"
    want = ([res, pk.SELECTOR, static, pk.SELECTOR, pk.SELECTOR,
             pk.SELECTOR, res] if with_constraints else [res, static, res])
    assert plane_calls == want


def _contract_cases():
    """(name, call) pairs that the wrapper must refuse, and the exception."""
    c = _case("random")
    nd, sp, sc = c.nodes, c.specs, c.scheduled

    def call(nodes=nd, specs=sp, checks=pk.ALL_CHECKS, bits=False,
             group_mask=None, scheduled=None):
        return lambda: pk.plane(nodes, specs, checks, bits, group_mask,
                                scheduled)

    def res(checks=pk.STATIC, bits=False, specs=sp, **kw):
        """The static plane with the resident pods, some field replaced."""
        return call(checks=checks, bits=bits, specs=specs,
                    scheduled=sc.replace(**kw) if kw else sc)

    # 2,000 label slots: a tile's label rows alone take 256 KB (the first
    # design refused 500, whose 128-node tile took as much)
    wide_labels = torch.zeros((nd.n, 2000), dtype=torch.int32)
    return {
        "no check": (call(checks=0), ValueError),
        "unknown check": (call(checks=32), ValueError),
        "int64 labels": (call(nodes=nd.replace(
            label_hash=nd.label_hash.long())), TypeError),
        "uint8 gate": (call(nodes=nd.replace(valid=nd.valid.to(torch.uint8))),
                       TypeError),
        "2-d sel_req": (call(specs=sp.replace(sel_req=sp.sel_req[:, 0])),
                        ValueError),
        "short tolerations": (call(specs=sp.replace(tol_key=sp.tol_key[:, 1:])),
                              ValueError),
        "fewer groups in req": (call(specs=sp.replace(req=sp.req[1:])),
                                ValueError),
        "non-contiguous ports": (call(nodes=nd.replace(
            used_ports=nd.used_ports.t().contiguous().t())), ValueError),
        "missing plane": (call(nodes=pk.NodePlanes(label_hash=nd.label_hash),
                               checks=pk.SELECTOR | pk.PORTS), ValueError),
        "int group mask": (call(group_mask=c.group_mask.int()), TypeError),
        "short group mask": (call(group_mask=c.group_mask[1:]), ValueError),
        "reasons without the standard slots": (call(
            nodes=nd.replace(cap=nd.cap[:, :3].contiguous(),
                             alloc=nd.alloc[:, :3].contiguous()),
            specs=sp.replace(req=sp.req[:, :3].contiguous()), bits=True),
            ValueError),
        "over shared memory": (call(nodes=nd.replace(label_hash=wide_labels),
                                    checks=pk.SELECTOR), ValueError),
        "a plane on another device": (call(nodes=nd.replace(
            taint_key=nd.taint_key.to("meta"))), ValueError),
        "no kernel for the device": (call(
            nodes=pk.NodePlanes(label_hash=nd.label_hash.to("meta")),
            specs=sp.replace(sel_req=sp.sel_req.to("meta"),
                             sel_neg=sp.sel_neg.to("meta")),
            checks=pk.SELECTOR), ValueError),
        "residents in the reason kind": (res(bits=True), ValueError),
        "int64 resident node_idx": (res(node_idx=sc.node_idx.long()),
                                    TypeError),
        "uint8 resident valid": (res(valid=sc.valid.to(torch.uint8)),
                                 TypeError),
        "short resident group_ref": (res(group_ref=sc.group_ref[1:]),
                                     ValueError),
        "2-d resident node_idx": (res(node_idx=sc.node_idx[:, None]),
                                  ValueError),
        "non-contiguous resident group_ref": (res(group_ref=torch.stack(
            [sc.group_ref, sc.group_ref], 1)[:, 0]), ValueError),
        "residents on another device": (res(valid=sc.valid.to("meta")),
                                        ValueError),
        "short anti_affinity_self": (res(specs=sp.replace(
            anti_affinity_self=sp.anti_affinity_self[1:])), ValueError),
        "int anti_affinity_self": (res(specs=sp.replace(
            anti_affinity_self=sp.anti_affinity_self.int())), TypeError),
        "residents without group_ref": (call(
            checks=pk.STATIC, scheduled=pk.NodePlanes()), ValueError),
    }


@pytest.mark.parametrize("name", list(_contract_cases()))
def test_wrapper_refuses_what_the_kernel_does_not_take(name):
    fn, exc = _contract_cases()[name]
    with pytest.raises(exc):
        fn()


def test_smem_of_the_default_widths_fits_a_cta():
    """At `Dims()` and G = 64 (one chunk) the full plane takes less than the
    card's 227 KB a CTA, and the main path's static plane with its resident
    pods leaves room for four CTAs an SM (228 KB of shared memory, 1 KB
    reserved a CTA)."""
    d = dict(pred_cases.dims_widths(Dims()), N=5120, G=64, R=8, P=40960)
    assert pk.smem_bytes(d, pk.ALL_CHECKS) <= pk.MAX_SMEM
    assert 4 * (pk.smem_bytes(d, pk.STATIC, resident=True) + 1024) <= 228 * 1024


def _first_design_smem(d: dict, checks: int) -> int:
    """The shared memory a CTA of the first design took (128 nodes' slot
    rows at an odd word stride, 8 groups' probe rows and a flags word)."""
    sel, tai, por, res = (bool(checks & c) for c in (
        pk.SELECTOR, pk.TAINTS, pk.PORTS, pk.RESOURCES))
    node = (sel * d["L"] + 2 * tai * d["T"] + por * d["NP"] + res * d["R"])
    group = 1 + (sel * (d["S"] * d["A"] + d["Sn"]) + 2 * tai * d["Tl"]
                 + por * d["PP"] + res * d["R"])
    return (128 * (node | 1 if node else 0) + 8 * group) * 4


@pytest.mark.parametrize("seed", range(4))
def test_kernel_takes_every_width_the_first_design_took(seed):
    """Widths drawn up to past the shared memory of a CTA: wherever the
    first design's CTA fitted, this design's fits too (its group chunk
    halves until it does), with or without residents."""
    rng = np.random.default_rng(seed)
    taken = 0
    for _ in range(500):
        top = int(rng.choice([8, 64, 600, 9000]))
        d = {k: int(rng.integers(0, top)) for k in
             ("L", "T", "NP", "R", "S", "A", "Sn", "Tl", "PP")}
        d.update(N=int(rng.integers(1, 10_000)), G=int(rng.integers(1, 300)),
                 P=int(rng.integers(0, 10_000)))
        checks = int(rng.integers(1, pk.ALL_CHECKS + 1))
        if _first_design_smem(d, checks) <= pk.MAX_SMEM:
            taken += 1
            for resident in (False, True):
                assert pk.smem_bytes(d, checks, resident) <= pk.MAX_SMEM, \
                    (d, checks, resident)
    assert taken > 50


def _scheduled(rng, g: int, n: int, p: int = 80) -> ScheduledPodTensors:
    """Resident pods with indices in and out of the plane: node_idx in
    [-2, n + 2), group_ref in [-g - 2, g + 2), and the int32 extremes."""
    node = rng.integers(-2, n + 2, p).astype(np.int32)
    grp = rng.integers(-g - 2, g + 2, p).astype(np.int32)
    node[0], grp[1] = 2 ** 31 - 1, -2 ** 31
    grp[2], node[2] = -1, 0
    i32 = torch.int32
    return ScheduledPodTensors(
        req=torch.zeros((p, 4), dtype=i32), node_idx=torch.from_numpy(node),
        group_ref=torch.from_numpy(grp),
        movable=torch.ones(p, dtype=torch.bool),
        blocks=torch.zeros(p, dtype=torch.bool),
        valid=torch.from_numpy(rng.random(p) < 0.8))


@pytest.mark.parametrize("g,n", [(3, 4), (1, 7), (33, 5), (5, 40)])
def test_resident_group_counts_reads_indices_as_the_reference(g, n):
    """A negative group row counts from the end once, as `.at[gr, ni]`
    reads it; a row or node still outside the plane is dropped (the
    port's `index_put_` raised on both before). `schedule` re-exports the
    plain term."""
    sched = _scheduled(np.random.default_rng(g * 100 + n), g, n)
    want = np.asarray(ref_schedule.resident_group_counts(_ref(sched), g, n))
    got = pk.resident_group_counts(sched, g, n)
    assert got.dtype == torch.int32
    assert got.numpy().tobytes() == want.tobytes()
    assert schedule.resident_group_counts is pk.resident_group_counts
    assert want.sum() > 0


def _ref_resident_plane(case, check_resources=False) -> np.ndarray:
    """The reference's expression: feasibility_mask & ~(anti_affinity_self
    & (resident_group_counts > 0))."""
    nodes, specs = _ref(case.nodes), _ref(case.specs)
    rc = ref_schedule.resident_group_counts(_ref(case.scheduled),
                                            case.specs.g, case.nodes.n)
    feas = ref_preds.feasibility_mask(nodes, specs,
                                      check_resources=check_resources)
    return np.asarray(feas & ~(specs.anti_affinity_self[:, None] & (rc > 0)))


@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("name", list(pred_cases.CASES))
def test_resident_plane_matches_reference(name, res):
    case = _case(name)
    want = _ref_resident_plane(case, res)
    checks = pk.STATIC | (pk.RESOURCES if res else 0)
    got = pk.plane(case.nodes, case.specs, checks, scheduled=case.scheduled)
    assert got.dtype == torch.bool
    assert got.numpy().tobytes() == want.tobytes()
    # every case has a resident pod of a self-anti-affine group, and the
    # group mask still clears its rows
    rc = pk.resident_group_counts(case.scheduled, case.specs.g, case.nodes.n)
    assert (case.specs.anti_affinity_self[:, None] & (rc > 0)).any()
    masked = pk.plane(case.nodes, case.specs, checks,
                      group_mask=case.group_mask, scheduled=case.scheduled)
    assert torch.equal(masked, got & case.group_mask[:, None])


@pytest.mark.parametrize("name", list(pred_cases.CASES))
def test_filter_and_drain_planes_match_reference(name):
    """`filter_pack_inputs`' mask and `sweep_inputs`' `feas` (one call of
    row P each) are the reference's expression."""
    case = _case(name)
    want = _ref_resident_plane(case)
    n = case.nodes.n
    mask = schedule.filter_pack_inputs(case.nodes, case.specs,
                                       case.scheduled)[1]
    feas = drain.sweep_inputs(
        case.nodes, case.specs, case.scheduled,
        torch.arange(n, dtype=torch.int32), torch.ones(n, dtype=torch.bool),
        8).feas
    assert mask.numpy().tobytes() == want.tobytes()
    assert feas.numpy().tobytes() == want.tobytes()

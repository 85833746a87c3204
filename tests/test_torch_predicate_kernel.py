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
from kubernetes_autoscaler_tpu_torch.models.cluster_state import Dims
from kubernetes_autoscaler_tpu_torch.ops import autoscale_step, predicates
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
    """The checks of every predicate_kernel.plane call made under it."""
    calls = []
    real = pk.plane

    def plane(nodes, specs, checks, bits=False, group_mask=None):
        calls.append(checks)
        return real(nodes, specs, checks, bits, group_mask)

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
    the templates and the drain's preparation (3), and with constraints
    four more selector planes (the options' and the filter's constraint
    state, the drain's topology inputs): one launch each on the card."""
    enc, groups = encode_world(PORT, build_world(PORT, seed=0), device="cpu")
    autoscale_step.run_once_fused(
        enc.nodes, enc.specs, enc.scheduled, groups,
        torch.full((groups.ng,), 16, dtype=torch.int32), Dims(),
        max_new_nodes=16, max_pods_per_node=32, planes=enc.planes,
        with_constraints=with_constraints)
    static = pk.STATIC
    want = ([static, pk.SELECTOR, static, pk.SELECTOR, pk.SELECTOR,
             pk.SELECTOR, static] if with_constraints else [static] * 3)
    assert plane_calls == want


def _contract_cases():
    """(name, call) pairs that the wrapper must refuse, and the exception."""
    c = _case("random")
    nd, sp = c.nodes, c.specs

    def call(nodes=nd, specs=sp, checks=pk.ALL_CHECKS, bits=False,
             group_mask=None):
        return lambda: pk.plane(nodes, specs, checks, bits, group_mask)

    wide_labels = torch.zeros((nd.n, 500), dtype=torch.int32)
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
    }


@pytest.mark.parametrize("name", list(_contract_cases()))
def test_wrapper_refuses_what_the_kernel_does_not_take(name):
    fn, exc = _contract_cases()[name]
    with pytest.raises(exc):
        fn()


def test_smem_of_the_default_widths_fits_a_cta():
    """At `Dims()` the full plane takes less than the card's 227 KB a CTA
    (and more than the 48 KB a launch gets without opting in)."""
    d = dict(pred_cases.dims_widths(Dims()), N=5120, G=64, R=8)
    assert 48 * 1024 < pk.smem_bytes(d, pk.ALL_CHECKS) <= pk.MAX_SMEM

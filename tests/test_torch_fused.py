"""The PyTorch port's fused control-loop step against the JAX reference.

Each package builds and encodes the same seeded world with its own encoder
(residents + drainability), then both run `run_once_fused` (the port on the
CPU, where the pack takes its plain version). Every leaf of FusedDecision
and FusedResident is compared: int and bool leaves byte for byte; the f32
leaves (util, waste, price, helped_req) within rtol 1e-6, because the two
frameworks may sum in another order, with the argmin of waste over valid
options identical.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (
    PORT,
    REF,
    assert_trees_equal,
    build_world,
    encode_world,
    leaves,
)

from kubernetes_autoscaler_tpu.models.cluster_state import Dims as RefDims
from kubernetes_autoscaler_tpu.ops import autoscale_step as ref_step
from kubernetes_autoscaler_tpu_torch.models.cluster_state import Dims
from kubernetes_autoscaler_tpu_torch.ops import autoscale_step as port_step

MAX_NEW = 16
MPN = 16
CHUNK = 8


def _run_both(seed, limit_cap=None, **world_kw):
    """Both packages' fused step on the same seeded world, each built and
    encoded by its own package. `limit_cap` maps the option count to caps."""
    ref_enc, ref_groups = encode_world(REF, build_world(REF, seed=seed,
                                                        **world_kw))
    port_enc, port_groups = encode_world(
        PORT, build_world(PORT, seed=seed, **world_kw), device="cpu")
    limit_cap = np.full((ref_groups.ng,), MAX_NEW, np.int32) \
        if limit_cap is None else limit_cap(ref_groups.ng)
    ref = ref_step.run_once_fused(
        ref_enc.nodes, ref_enc.specs, ref_enc.scheduled, ref_groups,
        jnp.asarray(limit_cap, jnp.int32), RefDims(), max_new_nodes=MAX_NEW,
        max_pods_per_node=MPN, chunk=CHUNK)
    got = port_step.run_once_fused(
        port_enc.nodes, port_enc.specs, port_enc.scheduled, port_groups,
        torch.as_tensor(limit_cap, dtype=torch.int32), Dims(),
        max_new_nodes=MAX_NEW, max_pods_per_node=MPN)
    return ref, got


def _check(ref, got):
    paths = assert_trees_equal(ref, got, float_rtol=1e-6)
    dec_ref, dec_got = leaves(ref[0]), leaves(got[0])
    valid = dec_ref[".scores.valid"]
    assert valid.tobytes() == dec_got[".scores.valid"].tobytes()
    if valid.any():
        inf = np.float32(3.0e38)
        assert (np.argmin(np.where(valid, dec_ref[".scores.waste"], inf))
                == np.argmin(np.where(valid, dec_got[".scores.waste"], inf)))
    return paths


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_step_matches_reference_with_residents(seed):
    def one_capped(ng):                   # one limiter-capped option
        cap = np.full((ng,), MAX_NEW, np.int32)
        cap[1] = 3
        return cap

    ref, got = _run_both(seed, one_capped)
    paths = _check(ref, got)
    assert "[1].removal.dest_node" in paths
    dec = leaves(ref[0])
    # the world exercises every phase: placements, a scale-up, drains
    assert dec[".verdict"].sum() > 0
    assert dec[".pending_after"].sum() > 0
    assert dec[".est_node_count"].sum() > 0
    assert dec[".drainable"].any() and dec[".has_blocker"].any()


def test_fused_step_matches_reference_when_everything_fits():
    ref, got = _run_both(2, fits=True)
    _check(ref, got)
    dec = leaves(ref[0])
    assert dec[".pending_after"].sum() == 0
    assert dec[".est_node_count"].sum() == 0


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    from kubernetes_autoscaler_tpu_torch.models.cluster_state import from_numpy
    from kubernetes_autoscaler_tpu_torch.models.encode import encode_cluster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nodes, pods, _ = build_world(PORT, n_nodes=3, n_pending_groups=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode_cluster(nodes, pods)
    ref_enc, _ = encode_world(REF, build_world(REF, n_nodes=3,
                                               n_pending_groups=1))
    host = type(ref_enc.nodes)(**{k: np.asarray(v) for k, v in
                                  vars(ref_enc.nodes).items()})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_numpy(host)
    assert from_numpy(host, device="cpu").cap.device.type == "cpu"

"""The PyTorch port's host encoder against the JAX reference's.

Both packages build the same seeded world (selectors, node affinity, taints
and tolerations, GPUs, hostPorts, self-anti-affinity, residents with and
without safe-to-evict) with their own object model; `encode_cluster`,
`apply_drainability` and `encode_node_groups` must then agree leaf by leaf:
dtype, shape and bytes. Tolerance: none.
"""

from __future__ import annotations

import pytest

from torch_parity import PORT, REF, assert_trees_equal, build_world, encode_world

from kubernetes_autoscaler_tpu_torch.utils.hashing import fold32


@pytest.mark.parametrize("seed", [0, 3])
def test_encode_cluster_and_drainability_match_reference(seed):
    ref_enc, ref_groups = encode_world(REF, build_world(REF, seed=seed))
    port_enc, port_groups = encode_world(PORT, build_world(PORT, seed=seed),
                                         device="cpu")
    for section in ("nodes", "specs", "scheduled", "planes"):
        assert_trees_equal(getattr(ref_enc, section),
                           getattr(port_enc, section))
    assert_trees_equal(ref_groups, port_groups)
    assert port_enc.node_names == ref_enc.node_names
    assert port_enc.zone_table.ids == ref_enc.zone_table.ids
    assert port_enc.registry.slots == ref_enc.registry.slots
    assert port_enc.group_pods == ref_enc.group_pods
    # the world exercises the planes under test
    specs = port_enc.specs
    assert specs.sel_req.any() and specs.tol_exact.any()
    assert specs.port_hash.any() and specs.anti_affinity_self.any()
    sched = port_enc.scheduled
    assert sched.movable.any() and sched.blocks.any()


def test_fold32_is_bit_identical_to_reference():
    from kubernetes_autoscaler_tpu.utils.hashing import fold32 as ref_fold32

    for s in ["", "a", "pool=a", "disk\x01", "dedicated\0infra\0NoSchedule",
              "8080/TCP", "ü-unicode", "x" * 300]:
        assert fold32(s) == ref_fold32(s)

"""The port's shadow audit (`audit/shadow.py`) in its control loop.

The reference's loop-level audit tests, on the port's loop on the CPU:
healthy loops audit with zero divergence; the `flip_bit` fault on the
fetched verdict plane is caught within its loop with a full evidence bundle
and healed by the forced re-encode; a persistent divergence degrades the
backend and refuses both directions until it stops; the drain surface
replays claimed placements through the host oracle. Against the JAX
auditor: under the same `parent_override` both packages draw the same
cells and drain candidates loop for loop. And the audit's assumption that
pinned tensors are never written in place holds across a loop.
"""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from test_torch_loop import _mod, _one_torch_thread  # noqa: F401 (autouse)

faults = _mod("torch", "sidecar.faults")


@pytest.fixture(autouse=True)
def _clear_faults():
    faults.clear()
    yield
    faults.clear()


def _world(pkg: str = "torch", n_nodes: int = 8, pending: int = 10,
           unfittable: int = 0):
    """test_shadow_audit._world, with `pkg`'s own objects."""
    t = _mod(pkg, "utils.testing")
    fake = _mod(pkg, "utils.fakecluster").FakeCluster()
    tmpl = t.build_test_node("tmpl", cpu_milli=8000, mem_mib=16384, pods=64)
    fake.add_node_group("ng1", tmpl, min_size=0, max_size=100)
    for i in range(n_nodes):
        nd = t.build_test_node(f"n{i}", cpu_milli=8000, mem_mib=16384,
                               pods=64)
        fake.add_existing_node("ng1", nd)
        fake.add_pod(t.build_test_pod(
            f"r{i}", cpu_milli=5000, mem_mib=2048,
            owner_name=f"rs{i % 3}", node_name=nd.name))
    for i in range(pending):
        fake.add_pod(t.build_test_pod(f"p{i}", cpu_milli=400, mem_mib=256,
                                      owner_name="prs"))
    for i in range(unfittable):
        fake.add_pod(t.build_test_pod(f"big{i}", cpu_milli=32000,
                                      mem_mib=512, owner_name="bigrs"))
    return fake


def _autoscaler(fake, tmp_path, pkg: str = "torch", journal: bool = True,
                **kw):
    o = _mod(pkg, "config.options")
    base = dict(
        shadow_audit=True,
        shadow_audit_dir=str(tmp_path / pkg / "audit"),
        shadow_audit_budget_ms=50.0,
        flight_recorder_dir=str(tmp_path / pkg / "flight"),
        node_shape_bucket=64, group_shape_bucket=16,
        max_new_nodes_static=64, max_pods_per_node=16,
        enable_dynamic_resource_allocation=False,
        enable_csi_node_aware_scheduling=False,
        scale_down_delay_after_add_s=0.0,
        node_group_defaults=o.NodeGroupDefaults(
            scale_down_unneeded_time_s=3600.0),
    )
    if journal:
        base["journal_dir"] = str(tmp_path / pkg / "journal")
    base.update(kw)
    extra = {"device": "cpu"} if pkg == "torch" else {}
    return _mod(pkg, "core.static_autoscaler").StaticAutoscaler(
        fake.provider, fake, options=o.AutoscalingOptions(**base),
        registry=_mod(pkg, "metrics.metrics").Registry(),
        eviction_sink=fake, **extra)


def test_healthy_loops_audit_with_zero_divergence(tmp_path):
    a = _autoscaler(_world(), tmp_path)
    for k in range(3):
        st = a.run_once(now=1000.0 + 10 * k)
        assert not st.audit_divergence
        assert st.loop_device_round_trips <= 2
    aud = a.shadow_auditor
    assert aud.divergences == 0
    assert aud.checks["plane"]["ok"] == 3
    assert aud.checks["scaleup"]["ok"] > 0
    assert aud.sample_log[-1]["seed"].endswith(":2")
    assert a.metrics.counter("shadow_audit_checks_total").value(
        surface="plane", outcome="ok") == 3
    assert a.supervisor.state == "healthy"


def test_flip_bit_caught_within_one_loop_with_full_bundle(tmp_path):
    a = _autoscaler(_world(), tmp_path)
    reg = a.metrics
    for k in range(2):
        a.run_once(now=1000.0 + 10 * k)
    faults.install([{"hook": "verdict_plane", "kind": "flip_bit",
                     "times": 1}], seed=7)
    st = a.run_once(now=1020.0)
    assert st.audit_divergence and st.audit_bundle_path
    assert a.supervisor.state == "suspect"
    assert reg.counter("backend_transitions_total").value(
        **{"from": "healthy", "to": "suspect",
           "cause": "audit_divergence"}) == 1
    with open(st.audit_bundle_path) as f:
        b = json.load(f)
    assert b["kind"] == "shadow-audit-divergence"
    assert b["journalCursor"][0] == 2
    assert b["traceId"]
    assert b["divergences"][0]["surface"] == "plane"
    assert b["divergences"][0]["xorBits"] is not None
    assert b["backend"]["platform"] == "cpu"
    assert reg.counter("flight_recorder_dumps_total").value(
        reason="audit_divergence") == 1
    assert "AuditDivergence" in {e["kind"] for e in a.event_sink.snapshot()}
    # next loop: the forced re-encode and a clean re-audit of the sample
    st2 = a.run_once(now=1030.0)
    assert not st2.audit_divergence
    assert reg.counter("encoder_encodes_total").value(
        mode="full", cause="audit_divergence") == 1
    assert a.shadow_auditor.pending_recheck is None
    assert a.supervisor.state == "healthy"
    assert a.last_audit_bundle == st.audit_bundle_path


def test_persistent_divergence_degrades_and_refuses_both_directions(
        tmp_path):
    a = _autoscaler(_world(unfittable=1), tmp_path)
    reg = a.metrics
    for k in range(2):
        a.run_once(now=1000.0 + 10 * k)
    faults.install([{"hook": "verdict_plane", "kind": "flip_bit",
                     "times": 0}], seed=7)
    a.run_once(now=1020.0)
    assert a.supervisor.state == "suspect"
    st = a.run_once(now=1030.0)
    assert st.audit_divergence
    assert a.supervisor.state == "degraded" and a.shadow_auditor.degraded
    st2 = a.run_once(now=1040.0)
    assert "AuditDivergence" in a.scale_up_orchestrator.last_noscaleup
    assert reg.gauge("unschedulable_pods_count").value(
        reason="AuditDivergence") > 0
    assert st2.scale_down_withheld
    assert st2.scale_up is None or not st2.scale_up.scaled_up
    kinds = {(e["kind"], e["reason"]) for e in a.event_sink.snapshot()}
    assert ("NoScaleUp", "AuditDivergence") in kinds
    faults.clear()
    for k in range(6):
        a.run_once(now=1050.0 + 10 * k)
    assert a.supervisor.state == "healthy"
    assert not a.shadow_auditor.degraded
    assert "AuditDivergence" not in a.scale_up_orchestrator.last_noscaleup


def test_drain_surface_verifies_claimed_placements(tmp_path):
    t = _mod("torch", "utils.testing")
    fake = _mod("torch", "utils.fakecluster").FakeCluster()
    fake.add_node_group("ng1", t.build_test_node(
        "tmpl", cpu_milli=8000, mem_mib=16384, pods=64), min_size=0,
        max_size=100)
    for i in range(4):
        fake.add_existing_node("ng1", t.build_test_node(
            f"n{i}", cpu_milli=8000, mem_mib=16384, pods=64))
    for j in range(2):
        fake.add_pod(t.build_test_pod(f"m{j}", cpu_milli=500, mem_mib=256,
                                      owner_name="rs", node_name="n0"))
    a = _autoscaler(fake, tmp_path)
    for k in range(3):
        a.run_once(now=1000.0 + 10 * k)
    aud = a.shadow_auditor
    assert aud.checks["drain"]["ok"] > 0, aud.checks
    assert aud.checks["drain"]["divergent"] == 0
    assert aud.sample_log[-1]["drain"] or aud.sample_log[-2]["drain"]


def test_sampling_equals_jax_under_the_same_parent_override(tmp_path):
    """Both auditors, seeded by one `parent_override` (record digests, and
    with them the journal's own seeds, differ between packages), draw the
    same cells and drain candidates and count the same checks."""
    logs, checks = {}, {}
    for pkg in ("jax", "torch"):
        fake = _world(pkg, n_nodes=6, pending=8, unfittable=1)
        # a budget no step exhausts: what is sampled must not depend on
        # either package's timing
        a = _autoscaler(fake, tmp_path, pkg=pkg, journal=False,
                        shadow_audit_budget_ms=1e6)
        a.shadow_auditor.parent_override = "same-parent"
        for k in range(4):
            if k == 2:
                t = _mod(pkg, "utils.testing")
                fake.remove_pod("p0")
                fake.add_pod(t.build_test_pod("p99", cpu_milli=400,
                                              mem_mib=256, owner_name="prs"))
            a.run_once(now=1000.0 + 10 * k)
        logs[pkg] = a.shadow_auditor.sample_log
        checks[pkg] = a.shadow_auditor.checks
    assert logs["torch"] == logs["jax"]
    assert all(row["cells"] for row in logs["torch"])
    assert checks["torch"] == checks["jax"]
    ref = _mod("jax", "audit.shadow").sample_indices
    got = _mod("torch", "audit.shadow").sample_indices
    for seed in ("", "abc:0", "f" * 64 + ":7"):
        assert got(seed, "scaleup-row", 5, 17) == ref(seed, "scaleup-row",
                                                       5, 17)


def _tensor_leaves(tree) -> list[torch.Tensor]:
    return [getattr(tree, f.name) for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "phased"])
def test_pinned_tensors_are_not_written_in_place(tmp_path, fused):
    """capture_world pins enc.nodes and enc.specs by reference: the filter's
    charge, the snapshot swap and the world store's patches must leave
    every pinned tensor's `_version` (PyTorch's in-place write counter)
    where it was, through the audit and through the next loop."""
    fake = _world(unfittable=1)
    a = _autoscaler(fake, tmp_path, fused_loop=fused)
    aud = a.shadow_auditor
    pinned = []
    real = aud.capture_world

    def capture(enc, parent_digest=""):
        leaves = _tensor_leaves(enc.nodes) + _tensor_leaves(enc.specs)
        pinned.append([(x, x._version) for x in leaves])
        return real(enc, parent_digest=parent_digest)

    aud.capture_world = capture
    t = _mod("torch", "utils.testing")
    for k in range(4):
        fake.add_pod(t.build_test_pod(f"q{k}", cpu_milli=600, mem_mib=256,
                                      owner_name="qrs"))
        a.run_once(now=1000.0 + 10 * k)
    assert len(pinned) == 4 and all(pinned)
    for loop, leaves in enumerate(pinned):
        moved = [i for i, (x, v) in enumerate(leaves) if x._version != v]
        assert moved == [], f"loop {loop}: leaves {moved} written in place"
    assert aud.divergences == 0


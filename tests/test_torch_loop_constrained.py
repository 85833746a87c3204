"""The port's control loop on worlds with topology spread and pod
(anti-)affinity, loop for loop against the JAX loop, on the CPU.

The scenarios of the reference's tests/test_constrained_runonce.py — zone
spread scales the empty zone, zone affinity scales the matching zone, the
host-check tier refuses constraints no template can satisfy — and a
consolidation world whose residents carry spread and anti-affinity, so the
planner confirms removals under constraints (natively). Each package builds
the scenario with its own objects and runs the same script, fused and
phased, with incremental encoding on and off; every loop's decision-surface
digests, fused mode, speculation outcome and round trips must be equal.
"""

from __future__ import annotations

import pytest

from test_torch_loop import _autoscaler, _mod, _surfaces

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
LOOPS = 4


def _zone_spread(pkg: str):
    api, t = _mod(pkg, "models.api"), _mod(pkg, "utils.testing")
    fake = _mod(pkg, "utils.fakecluster").FakeCluster()
    for z in ("a", "b"):
        fake.add_node_group(f"ng-{z}", t.build_test_node(
            f"tmpl-{z}", cpu_milli=4000, mem_mib=8192, zone=z),
            min_size=1, max_size=10)
    fake.add_existing_node("ng-a", t.build_test_node(
        "a0", cpu_milli=4000, mem_mib=8192, zone="a"))
    # zone b exists (an eligible domain with count 0) but is full: maxSkew
    # 1 needs new zone-b capacity
    fake.add_existing_node("ng-b", t.build_test_node(
        "b0", cpu_milli=150, mem_mib=8192, zone="b"))
    for i in range(2):
        p = t.build_test_pod(f"r{i}", cpu_milli=200, mem_mib=64,
                             labels={"app": "w"}, owner_name="w-rs",
                             node_name="a0")
        p.phase = "Running"
        fake.add_pod(p)

    def pending(i):
        p = t.build_test_pod(f"p{i}", cpu_milli=200, mem_mib=64,
                             labels={"app": "w"}, owner_name="w-rs")
        p.topology_spread = [api.TopologySpreadConstraint(
            max_skew=1, topology_key=ZONE, match_labels={"app": "w"})]
        return p

    for i in range(3):
        fake.add_pod(pending(i))

    def script(loop):
        if loop == 2:
            fake.add_pod(pending(3))
    return fake, script


def _zone_affinity(pkg: str):
    api, t = _mod(pkg, "models.api"), _mod(pkg, "utils.testing")
    fake = _mod(pkg, "utils.fakecluster").FakeCluster()
    for z in ("a", "b"):
        fake.add_node_group(f"ng-{z}", t.build_test_node(
            f"tmpl-{z}", cpu_milli=4000, mem_mib=8192, zone=z),
            min_size=1, max_size=10)
        fake.add_existing_node(f"ng-{z}", t.build_test_node(
            f"{z}0", cpu_milli=1000, mem_mib=8192, zone=z))
    db = t.build_test_pod("db", cpu_milli=800, mem_mib=64,
                          labels={"app": "db"}, owner_name="db-rs",
                          node_name="b0")
    db.phase = "Running"
    fake.add_pod(db)
    for i in range(4):
        p = t.build_test_pod(f"w{i}", cpu_milli=800, mem_mib=64,
                             labels={"app": "w"}, owner_name="w-rs")
        p.pod_affinity = [api.AffinityTerm(match_labels={"app": "db"},
                                           topology_key=ZONE)]
        fake.add_pod(p)
    return fake, lambda loop: None


def _unsatisfiable(pkg: str):
    api, t = _mod(pkg, "models.api"), _mod(pkg, "utils.testing")
    fake = _mod(pkg, "utils.fakecluster").FakeCluster()
    fake.add_node_group("ng1", t.build_test_node(
        "tmpl", cpu_milli=4000, mem_mib=8192), min_size=1, max_size=10)
    fake.add_existing_node("ng1", t.build_test_node(
        "n0", cpu_milli=100, mem_mib=128))
    for i in range(3):
        p = t.build_test_pod(f"p{i}", cpu_milli=500, mem_mib=64,
                             labels={"app": "w"}, owner_name="w-rs")
        # an exotic topology key: the host-check tier, whose oracle refutes
        # every template
        p.pod_affinity = [api.AffinityTerm(
            match_labels={"app": "never-exists"},
            topology_key="rack.example.com/id")]
        fake.add_pod(p)
    return fake, lambda loop: None


def _consolidation(pkg: str):
    """Lightly loaded nodes over three zones whose residents carry zone
    spread and hostname anti-affinity: scale-down drains some of them."""
    api, t = _mod(pkg, "models.api"), _mod(pkg, "utils.testing")
    fake = _mod(pkg, "utils.fakecluster").FakeCluster()
    fake.add_node_group("ng1", t.build_test_node(
        "tmpl", cpu_milli=4000, mem_mib=8192, zone="a"), min_size=0,
        max_size=20)
    zones = ["a", "b", "c"]
    for i in range(9):
        fake.add_existing_node("ng1", t.build_test_node(
            f"n{i}", cpu_milli=4000, mem_mib=8192, zone=zones[i % 3]))
    for i in range(9):
        p = t.build_test_pod(f"s{i}", cpu_milli=300, mem_mib=64,
                             labels={"app": "s"}, owner_name="s-rs",
                             node_name=f"n{i}")
        p.phase = "Running"
        p.topology_spread = [api.TopologySpreadConstraint(
            max_skew=2, topology_key=ZONE, match_labels={"app": "s"})]
        fake.add_pod(p)
        if i % 2 == 0:
            q = t.build_test_pod(f"h{i}", cpu_milli=200, mem_mib=64,
                                 labels={"app": "h"}, owner_name="h-rs",
                                 node_name=f"n{i}")
            q.phase = "Running"
            q.anti_affinity = [api.AffinityTerm(match_labels={"app": "h"},
                                                topology_key=HOST)]
            fake.add_pod(q)

    def script(loop):
        if loop == 1:
            p = t.build_test_pod("late", cpu_milli=300, mem_mib=64,
                                 labels={"app": "s"}, owner_name="s-rs")
            p.topology_spread = [api.TopologySpreadConstraint(
                max_skew=2, topology_key=ZONE, match_labels={"app": "s"})]
            fake.add_pod(p)
    return fake, script


SCENARIOS = {"zone-spread": _zone_spread, "zone-affinity": _zone_affinity,
             "unsatisfiable": _unsatisfiable, "consolidation": _consolidation}


def _run(pkg: str, scenario: str, monkeypatch, **kw):
    fake, script = SCENARIOS[scenario](pkg)
    nc = _mod(pkg, "core.scaledown.native_confirm")
    calls = []
    real = nc.confirm
    monkeypatch.setattr(nc, "confirm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    a = _autoscaler(pkg, fake, node_shape_bucket=16, group_shape_bucket=16,
                    **kw)
    rows, states = [], []
    for loop in range(LOOPS):
        script(loop)
        st = a.run_once(now=1000.0 + 10 * loop)
        rows.append(_surfaces(pkg, a, st))
        states.append(st)
    return rows, states, len(calls), fake


@pytest.mark.parametrize("incremental", [True, False],
                         ids=["incremental", "full-encode"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "phased"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_constrained_loop_matches_jax_loop(scenario, fused, incremental,
                                           monkeypatch):
    kw = dict(fused_loop=fused, incremental_encode=incremental)
    ref, _, _, _ = _run("jax", scenario, monkeypatch, **kw)
    got, states, native, fake = _run("torch", scenario, monkeypatch, **kw)
    for loop, (r, g) in enumerate(zip(ref, got)):
        assert g == r, (loop, r, g)
    assert all(st.fused_mode == ("fused" if fused else "phased")
               for st in states)
    first = states[0].scale_up
    if scenario == "zone-spread":
        assert first is not None and list(first.increases) == ["ng-b"]
    elif scenario == "zone-affinity":
        assert first is not None and list(first.increases) == ["ng-b"]
    elif scenario == "unsatisfiable":
        assert all(st.scale_up is None or not st.scale_up.scaled_up
                   for st in states)
        assert len(fake.nodes) == 1
    else:
        assert sum(len(st.scale_down_deleted) for st in states) > 0
        assert native > 0

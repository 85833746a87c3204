"""The port's native scale-down confirmation (its own csrc/host/kaconfirm.cc,
built with the host compiler on first use) against the port's Python pass
and against the JAX package's native pass.

Each scenario of the reference's tests/test_native_confirm.py and
tests/test_native_constrained.py is built by each package with its own
objects; the port's planner confirms it natively and through the Python
pass, the JAX package's planner natively, and the three plans (accepted
nodes, pods to move, destinations) must be equal.
"""

from __future__ import annotations

import importlib
import random

import numpy as np
import pytest

from torch_parity import PORT, REF

from kubernetes_autoscaler_tpu_torch.core.scaledown import native_confirm
from kubernetes_autoscaler_tpu_torch.ops.kernels import build

PKG = {"jax": REF, "torch": PORT}
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{PKG[pkg]}.{name}")


def test_port_builds_its_own_kaconfirm(monkeypatch, tmp_path):
    """`available()` builds the port's copy into its _build directory (here:
    a fresh one) with the host compiler and loads it."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_confirm, "_lib", None)
    monkeypatch.setattr(native_confirm, "_available", None)
    assert native_confirm.available()
    libs = list(tmp_path.glob("libkaconfirm-*.so"))
    assert len(libs) == 1
    assert native_confirm.SOURCE == "kaconfirm.cc"
    assert (build.HOST_DIR / native_confirm.SOURCE).exists()


def test_a_failed_build_is_logged_and_leaves_the_python_pass(
        monkeypatch, tmp_path, caplog):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "HOST_DIR", tmp_path)       # no source here
    (tmp_path / "kaconfirm.cc").write_text("this is not C++\n")
    monkeypatch.setattr(native_confirm, "_lib", None)
    monkeypatch.setattr(native_confirm, "_available", None)
    with caplog.at_level("WARNING"):
        assert not native_confirm.available()
    assert "native confirmation pass unavailable" in caplog.text


# ------------------------------------------------------------- worlds


def _confirm_world(pkg, rng, n_nodes):
    """tests/test_native_confirm._world with `pkg`'s objects."""
    t = _mod(pkg, "utils.testing")
    fake = _mod(pkg, "utils.fakecluster").FakeCluster()
    tmpl = t.build_test_node("tmpl", cpu_milli=8000, mem_mib=16384, pods=32)
    fake.add_node_group("ng1", tmpl, min_size=0, max_size=4 * n_nodes)
    nodes, pods = [], []
    for i in range(n_nodes):
        nd = t.build_test_node(f"n{i}", cpu_milli=8000, mem_mib=16384, pods=32)
        fake.add_existing_node("ng1", nd)
        nodes.append(nd)
        for j in range(rng.randint(0, 4)):
            p = t.build_test_pod(
                f"p{i}-{j}", cpu_milli=rng.choice([500, 1000, 1500]),
                mem_mib=rng.choice([256, 512]),
                owner_name=f"rs{rng.randint(0, 4)}", node_name=nd.name)
            fake.add_pod(p)
            pods.append(p)
    return fake, nodes, pods, dict(node_bucket=64, group_bucket=16)


def _consolidation_world(pkg):
    t = _mod(pkg, "utils.testing")
    fake = _mod(pkg, "utils.fakecluster").FakeCluster()
    tmpl = t.build_test_node("tmpl", cpu_milli=10_000, mem_mib=32_768, pods=16)
    fake.add_node_group("ng1", tmpl, min_size=0, max_size=100)
    nodes, pods = [], []
    for i in range(20):
        nd = t.build_test_node(f"n{i}", cpu_milli=10_000, mem_mib=32_768,
                               pods=16)
        fake.add_existing_node("ng1", nd)
        nodes.append(nd)
        for j in range(2):
            p = t.build_test_pod(f"p{i}-{j}", cpu_milli=2000, mem_mib=512,
                                 owner_name=f"rs{i % 5}", node_name=nd.name)
            fake.add_pod(p)
            pods.append(p)
    return fake, nodes, pods, dict(node_bucket=64, group_bucket=16)


def _constrained_world(pkg, seed):
    """tests/test_native_constrained._rand_world with `pkg`'s objects."""
    api, t = _mod(pkg, "models.api"), _mod(pkg, "utils.testing")
    rng = np.random.default_rng(seed)
    fake = _mod(pkg, "utils.fakecluster").FakeCluster()
    tmpl = t.build_test_node("tmpl", cpu_milli=8000, mem_mib=16384)
    fake.add_node_group("ng1", tmpl, min_size=0, max_size=400)
    n_nodes = int(rng.integers(20, 45))
    zones = ["za", "zb", "zc", ""][: int(rng.integers(2, 5))]
    nodes = []
    for i in range(n_nodes):
        nd = t.build_test_node(f"n{i}", cpu_milli=8000, mem_mib=16384,
                               zone=zones[i % len(zones)])
        fake.add_existing_node("ng1", nd)
        nodes.append(nd)
    pods = []
    for i in range(n_nodes):
        for j in range(int(rng.integers(0, 5))):
            kind = rng.integers(0, 7)
            app = f"app{int(rng.integers(0, 5))}"
            p = t.build_test_pod(
                f"p{i}-{j}", cpu_milli=int(rng.integers(200, 1500)),
                mem_mib=256, owner_name=f"rs-{app}", node_name=f"n{i}",
                labels={"app": app})
            p.phase = "Running"
            if kind == 1:
                p.topology_spread = [api.TopologySpreadConstraint(
                    max_skew=int(rng.integers(1, 4)), topology_key=ZONE,
                    match_labels={"app": app})]
            elif kind == 2:
                p.anti_affinity = [api.AffinityTerm(match_labels={"app": app},
                                                    topology_key=HOST)]
            elif kind == 3:
                p.anti_affinity = [api.AffinityTerm(match_labels={"app": app},
                                                    topology_key=ZONE)]
            elif kind == 4:
                p.topology_spread = [api.TopologySpreadConstraint(
                    max_skew=int(rng.integers(1, 4)), topology_key=HOST,
                    match_labels={"app": app})]
            elif kind == 5:
                p.pod_affinity = [api.AffinityTerm(
                    match_labels={"app": app},
                    topology_key=ZONE if rng.integers(0, 2) else HOST)]
            elif kind == 6:
                p.host_ports = ((8000 + int(rng.integers(0, 3)), "TCP"),)
            fake.add_pod(p)
            pods.append(p)
    return fake, nodes, pods, dict(node_bucket=64, group_bucket=64)


def _fixed_world(pkg, name):
    """The fixed scenarios of tests/test_native_constrained.py."""
    api, t = _mod(pkg, "models.api"), _mod(pkg, "utils.testing")
    fake = _mod(pkg, "utils.fakecluster").FakeCluster()
    tmpl = t.build_test_node("tmpl", cpu_milli=8000, mem_mib=16384)
    fake.add_node_group("ng1", tmpl, min_size=0, max_size=40)
    zones = {"spread-skew": ["za", "zb", "zc"],
             "pod-affinity": ["za", "za", "zb", "zb"]}.get(name)
    n = {"host-ports": 5, "spread-skew": 3}.get(name, 4)
    nodes = []
    for i in range(n):
        nd = t.build_test_node(f"n{i}", cpu_milli=8000, mem_mib=16384,
                               zone=zones[i] if zones else "")
        fake.add_existing_node("ng1", nd)
        nodes.append(nd)

    def pod(pname, node, app, cpu=500, **kw):
        p = t.build_test_pod(pname, cpu_milli=cpu, mem_mib=128,
                             owner_name=f"rs-{app}", node_name=node,
                             labels={"app": app}, **kw)
        p.phase = "Running"
        fake.add_pod(p)
        return p

    pods = []
    for i in range(3):
        if name == "spread-skew":
            p = pod(f"p{i}", f"n{i}", "w")
            p.topology_spread = [api.TopologySpreadConstraint(
                max_skew=1, topology_key=ZONE, match_labels={"app": "w"})]
        elif name == "host-spread":
            p = pod(f"s{i}", f"n{i}", "s")
            p.topology_spread = [api.TopologySpreadConstraint(
                max_skew=1, topology_key=HOST, match_labels={"app": "s"})]
        elif name == "host-ports":
            p = pod(f"w{i}", f"n{i}", "w", host_port=8080)
        elif name == "anti-self-host":
            p = pod(f"a{i}", f"n{i}", "a")
            p.anti_affinity = [api.AffinityTerm(match_labels={"app": "a"},
                                                topology_key=HOST)]
        else:
            break
        pods.append(p)
    if name == "pod-affinity":
        pods.append(pod("db-0", "n0", "db", cpu=1000))
        web = pod("web-0", "n1", "web")
        web.pod_affinity = [api.AffinityTerm(match_labels={"app": "db"},
                                             topology_key=ZONE)]
        pods.append(web)
    return fake, nodes, pods, dict(node_bucket=64, group_bucket=64)


def _plan(pkg, world, native, monkeypatch, pdbs=(), **opt_kw):
    """One package's planner over `world`: {node: (is_empty, pods to move,
    destinations)} of nodes_to_delete, the native pass or the Python pass."""
    fake, nodes, pods, enc_kw = world
    o = _mod(pkg, "config.options")
    nc = _mod(pkg, "core.scaledown.native_confirm")
    monkeypatch.setattr(nc, "_available", None if native else False)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    enc = _mod(pkg, "models.encode").encode_cluster(nodes, pods, **enc_kw,
                                                     **kw)
    rules = _mod(pkg, "simulator.drainability.rules")
    rules.apply_drainability(enc, rules.DrainOptions())
    base = dict(node_shape_bucket=enc_kw["node_bucket"],
                group_shape_bucket=enc_kw["group_bucket"],
                max_new_nodes_static=32, max_pods_per_node=32, drain_chunk=8,
                max_scale_down_parallelism=1000,
                max_drain_parallelism=1000, max_empty_bulk_delete=1000,
                node_group_defaults=o.NodeGroupDefaults(
                    scale_down_unneeded_time_s=0.0,
                    scale_down_unready_time_s=0.0))
    base.update(opt_kw)
    tracker = None
    if pdbs:
        pdb = _mod(pkg, "core.scaledown.pdb")
        tracker = pdb.RemainingPdbTracker(
            [pdb.PodDisruptionBudget(name, match_labels=dict(sel),
                                     disruptions_allowed=allowed)
             for name, sel, allowed in pdbs])
    pl = _mod(pkg, "core.scaledown.planner").Planner(
        fake.provider, o.AutoscalingOptions(**base), pdb_tracker=tracker)
    calls = []
    real = nc.confirm
    monkeypatch.setattr(nc, "confirm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    pl.update(enc, nodes, now=1000.0)
    out = pl.nodes_to_delete(enc, nodes, now=1000.0)
    monkeypatch.setattr(nc, "confirm", real)
    plan = {r.node.name: (r.is_empty, sorted(r.pods_to_move),
                          dict(sorted(r.destinations.items()))) for r in out}
    return plan, len(calls)


def _check(build_world, monkeypatch, **kw):
    """The port's native plan == the port's Python plan == the JAX
    package's native plan; the native pass really ran."""
    got, calls = _plan("torch", build_world("torch"), True, monkeypatch, **kw)
    python, _ = _plan("torch", build_world("torch"), False, monkeypatch, **kw)
    ref, _ = _plan("jax", build_world("jax"), True, monkeypatch, **kw)
    assert got == python
    assert got == ref
    return got, calls


@pytest.mark.parametrize("trial", range(5))
def test_randomized_plans_match(trial, monkeypatch):
    n_nodes = random.Random(100 + trial).randint(6, 14)

    def world(pkg):
        rng = random.Random(100 + trial)
        rng.randint(6, 14)
        return _confirm_world(pkg, rng, n_nodes)

    _check(world, monkeypatch, max_scale_down_parallelism=n_nodes,
           max_drain_parallelism=n_nodes, max_empty_bulk_delete=n_nodes)


@pytest.mark.parametrize("budgets", [
    dict(max_scale_down_parallelism=3),
    dict(max_drain_parallelism=1, max_empty_bulk_delete=2),
    dict(max_empty_bulk_delete=0, max_drain_parallelism=4)],
    ids=["total", "drain-and-empty", "no-empty"])
def test_plans_match_with_budgets(budgets, monkeypatch):
    _check(lambda pkg: _confirm_world(pkg, random.Random(7), 12),
           monkeypatch, **budgets)


def test_consolidation_plans_match(monkeypatch):
    plan, calls = _check(_consolidation_world, monkeypatch)
    assert len(plan) == 12 and calls == 1


@pytest.mark.parametrize("trial", range(2))
def test_plans_match_with_pdbs(trial, monkeypatch):
    rng = random.Random(300 + trial)
    n_nodes = rng.randint(8, 14)
    g1, every = rng.randint(0, 3), rng.randint(2, 8)

    def world(pkg):
        fake, nodes, pods, kw = _confirm_world(pkg, random.Random(999 + trial),
                                               n_nodes)
        for j, p in enumerate(pods):
            if j % 2 == 0:
                p.labels["guard"] = "yes"
        return fake, nodes, pods, kw

    _check(world, monkeypatch,
           pdbs=[("g1", {"guard": "yes"}, g1), ("all", {}, every)])


@pytest.mark.parametrize("seed", [11, 23, 37, 41, 59, 73, 97, 113])
def test_constrained_plans_match(seed, monkeypatch):
    _check(lambda pkg: _constrained_world(pkg, seed), monkeypatch)


@pytest.mark.parametrize("name", ["spread-skew", "host-spread", "pod-affinity",
                                  "host-ports", "anti-self-host"])
def test_fixed_constrained_plans_match(name, monkeypatch):
    plan, calls = _check(lambda pkg: _fixed_world(pkg, name), monkeypatch)
    assert calls == 1
    if name == "anti-self-host":
        assert list(plan) == ["n3"]
    if name == "spread-skew":
        assert len(plan) <= 1


def test_frontier_hint_rewinds_on_revert():
    """The reference's regression case on the raw entry point: a failed
    candidate's revert rewinds every group's first-fit frontier. The port's
    library and the JAX package's give the same arrays."""
    ref_nc = importlib.import_module(f"{REF}.core.scaledown.native_confirm")
    outs = []
    for nc in (native_confirm, ref_nc):
        outs.append(nc.confirm(
            np.array([[1], [0], [0], [0]], np.int64),
            np.ones((2, 4), np.uint8), np.ones((4,), np.uint8),
            np.array([[1], [1]], np.int32), np.array([3, 2], np.int32),
            np.array([0, 1, 2], np.int32), np.array([0, 1, 1], np.int32),
            np.array([0, 2, 3], np.int32), np.array([0, 0], np.int32),
            np.array([10], np.int32), None, None, np.zeros((4, 1), np.int64),
            empty_budget=10, drain_budget=10, total_budget=10,
            max_slot_id=2))
    accept, reason, dest = outs[0]
    assert list(accept) == [0, 1] and reason[0] == 1 and dest[2] == 0
    for a, b in zip(*outs):
        assert a.tobytes() == b.tobytes()

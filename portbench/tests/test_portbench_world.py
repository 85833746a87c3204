"""The world and traffic generator: one seed, one world; every seed the same
sizes; each configuration file's sizes."""

import numpy as np
import pytest

from portbench import spec, world
from portbench.tests.conftest import SEED


@pytest.mark.parametrize("cfg_name,traffic_name", [
    ("ca-5k", "steady"), ("ca-5k-affinity", "steady"),
    ("ca-5k-affinity", "consolidate")])
def test_variants_are_the_seeds_and_the_files(cfg_name, traffic_name):
    cfg = spec.load("configs", cfg_name)
    tr = spec.load("traffic", traffic_name)
    a = world.variants(cfg, tr, SEED)
    b = world.variants(cfg, tr, SEED)
    c = world.variants(cfg, tr, SEED + 1)
    assert len(a) == tr["variants"] == 4
    for x, y in zip(a, b):
        assert x.counts == y.counts and x.burst == y.burst
        assert np.array_equal(x.residents, y.residents)
    # the seed moves the churn, not the amount of it
    assert len(cfg["group_sizes"]) == cfg["pending_groups"]
    if tr["churn"] or tr["residents_leave_per_variant"]:
        assert ([x.counts for x in a] != [x.counts for x in c]
                or any((x.residents != y.residents).any() for x, y in zip(a, c)))
    n_res = cfg["nodes"] * cfg["residents_per_node"]
    assert n_res == 40000
    for v in a:
        assert len(v.counts) == cfg["pending_groups"] == 25
        if tr["pending"]:
            assert sum(v.counts) == cfg["pending_pods"] == 50000
        else:
            assert sum(v.counts) == 0
        assert v.burst == (200 if tr["burst"] and v.index == 2 else 0)
        assert int(v.residents.sum()) == n_res - tr["residents_leave_per_variant"] * v.index
    if tr["churn"]:
        for x, y in zip(a, a[1:]):
            moved = np.abs(np.subtract(x.counts, y.counts)).sum()
            assert 0 < moved <= 2 * tr["churn"]


def test_objects_follow_the_configuration():
    cfg = spec.load("configs", "ca-5k-affinity")
    tr = spec.load("traffic", "steady")
    small = {**cfg, "nodes": 50, "pending_pods": 250}
    v = world.variants(small, {**tr, "churn": 20}, SEED)[2]
    from portbench.program import api

    nodes, pods, templates = world.objects(small, tr, v, api())
    assert len(nodes) == 50 and len(templates) == cfg["node_groups"]
    assert sum(1 for n in nodes if n.taints) == 5
    pending = [p for p in pods if not p.node_name]
    assert len(pending) == sum(v.counts) + 200
    assert sum(1 for p in pods if p.node_name) == int(v.residents.sum())
    kinds = {p.owner.name: (bool(p.topology_spread), bool(p.anti_affinity),
                            bool(p.pod_affinity)) for p in pending}
    assert kinds["rs-1"] == (True, False, False)
    assert kinds["rs-3"] == (False, True, False)
    assert kinds["rs-4"] == (False, False, True)
    assert kinds["rs-5"] == (False, False, False)


def test_cloned_pods_equal_what_build_test_pod_makes():
    from portbench.program import api

    API = api()

    cfg = {**spec.load("configs", "ca-5k-affinity"), "nodes": 20,
           "pending_pods": 100}
    tr = spec.load("traffic", "steady")
    v = world.variants(cfg, {**tr, "churn": 10}, SEED)[2]
    _, pods, _ = world.objects(cfg, tr, v, API)
    by_name = {p.name: p for p in pods}
    tol = [API.Toleration(key="dedicated", operator="Equal", value="infra",
                          effect="NoSchedule")]
    for g, count in enumerate(v.counts):
        for i in (0, count - 1):
            want = API.build_test_pod(
                f"pod-{g}-{i}", cpu_milli=cfg["group_sizes"][g][0],
                mem_mib=cfg["group_sizes"][g][1],
                owner_name=f"rs-{g}",
                node_selector={"disk": "ssd"} if g % 4 == 0 else {},
                tolerations=tol if g % 5 == 0 else [],
                gpus=1 if g % 7 == 0 else 0, labels={"grp": f"g{g}"})
            got = by_name[f"pod-{g}-{i}"]
            for f in ("topology_spread", "anti_affinity", "pod_affinity"):
                setattr(want, f, getattr(got, f))
            assert got == want
    assert bool(by_name["pod-1-0"].topology_spread)
    k = int(np.flatnonzero(v.residents)[-1])
    assert by_name[f"res-{k}"] == API.build_test_pod(
        f"res-{k}", cpu_milli=800, mem_mib=256, owner_name=f"rs{k % 17}",
        node_name=f"node-{k // 8}", labels={"app": f"a{k % 17 % 5}"})
    assert by_name["burst-199"] == API.build_test_pod(
        "burst-199", cpu_milli=14000, mem_mib=4096, owner_name="burst-rs")

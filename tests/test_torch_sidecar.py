"""The port's simulation sidecar (`kubernetes_autoscaler_tpu_torch.sidecar`)
against the JAX package's, on the CPU.

Compared: the codec (`fold32_batch`, a delta sequence with upserts, an
update, a delete and a reused slot: every numpy export byte-equal to the
JAX `NativeSnapshotState`'s, versions and counts equal), the committed
goldens (each replays exactly through the port's codec; the port's goldens
and `kacodec.cc` are the reference's bytes), the batched variants (lane i
of `scale_up_sim_batch` / `scale_down_sim_batch` equals the serial sim on
lane i's world, padded lanes and permuted tenants included), and the
services: for the same KAD1/KAUX payloads, the port's `ApplyDelta` acks
and its `ScaleUpSim`, `ScaleDownSim` and `WhatIf` responses equal the JAX
service's, batched and serial, on unconstrained tenants and on a
KAUX-constrained one (routed serial on both; WhatIf refused on both).
Tolerance: none — every field, floats included, is compared with `==`
(identical on the CPU); only the `lifecycle` timing block is dropped.

Worlds are at most 16 nodes a tenant, and one service of each package is
shared by the module, so the JAX side compiles each program once.
"""

from __future__ import annotations

import importlib
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import PORT, REF

ROOT = Path(__file__).resolve().parents[1]
PKG = {"jax": REF, "torch": PORT}
MIB = 1024 * 1024
ZONE = "topology.kubernetes.io/zone"
TENANTS = ("t0", "t1", "t2")

NGS = [
    {"id": "ng-4c",
     "template": {"name": "t4", "capacity": {"cpu": 4.0, "memory": 8192 * MIB,
                                             "pods": 110}},
     "max_new": 10, "price": 1.0},
    {"id": "ng-8c",
     "template": {"name": "t8", "capacity": {"cpu": 8.0,
                                             "memory": 16384 * MIB,
                                             "pods": 110}},
     "max_new": 6, "price": 1.7},
    {"id": "ng-2c",
     "template": {"name": "t2", "capacity": {"cpu": 2.0, "memory": 4096 * MIB,
                                             "pods": 110}},
     "max_new": 20, "price": 0.45},
]


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{PKG[pkg]}.{name}")


def _world_writer(pkg: str, seed: int, n_nodes: int = 10, n_pending: int = 14):
    """A small tenant world from a seed: nodes of mixed size, residents (the
    movable ones drain, one blocks its node), and pending pods in three
    owner groups, one of them too big for every existing node."""
    wire = _mod(pkg, "sidecar.wire")
    t = _mod(pkg, "utils.testing")
    rng = np.random.RandomState(seed)
    w = wire.DeltaWriter()
    for i in range(n_nodes):
        w.upsert_node(t.build_test_node(
            f"n{seed}-{i}", cpu_milli=int(rng.choice([2000, 4000, 8000])),
            mem_mib=int(rng.choice([4096, 8192]))))
    for i in range(n_nodes):
        if i % 3 == 2:
            continue
        w.upsert_pod(t.build_test_pod(
            f"r{seed}-{i}", cpu_milli=int(rng.choice([200, 500, 900])),
            mem_mib=256, owner_name=f"res{i % 2}", node_name=f"n{seed}-{i}"),
            movable=i % 4 != 0, blocks=i == 4)
    for i in range(n_pending):
        big = i % 7 == 6
        w.upsert_pod(t.build_test_pod(
            f"p{seed}-{i}", cpu_milli=9000 if big else 300 + 200 * (i % 3),
            mem_mib=512, owner_name=f"rs{i % 3}"))
    return w


def _churn_writer(pkg: str, seed: int):
    """Second delta: an updated pending pod, a deleted resident, a new
    node in the freed slot's wake, a cordoned node."""
    wire = _mod(pkg, "sidecar.wire")
    t = _mod(pkg, "utils.testing")
    w = wire.DeltaWriter()
    w.upsert_pod(t.build_test_pod(f"p{seed}-0", cpu_milli=1500, mem_mib=512,
                                  owner_name="rs0"))
    w.delete_pod(f"uid-default/r{seed}-1")
    w.delete_node(f"n{seed}-3")
    w.upsert_node(t.build_test_node(f"n{seed}-x", cpu_milli=4000,
                                    mem_mib=8192))
    cordoned = t.build_test_node(f"n{seed}-0", cpu_milli=8000, mem_mib=8192)
    cordoned.unschedulable = True
    w.upsert_node(cordoned)
    for i in range(3):
        w.upsert_pod(t.build_test_pod(f"q{seed}-{i}", cpu_milli=700,
                                      mem_mib=256, owner_name="rs9"))
    return w


def _constrained_writer(pkg: str):
    """A KAUX tenant (tests/test_sidecar_constraints.py's zone-affinity
    world plus a zone spread): two zones, a resident the affinity points
    at, pending pods that need it."""
    wire = _mod(pkg, "sidecar.wire")
    t = _mod(pkg, "utils.testing")
    api = _mod(pkg, "models.api")
    w = wire.DeltaWriter()
    for z in ("a", "b"):
        for i in range(2):
            w.upsert_node(t.build_test_node(f"{z}{i}", cpu_milli=4000,
                                            mem_mib=8192, zone=z))
    db = t.build_test_pod("db", cpu_milli=100, mem_mib=64,
                          labels={"app": "db"}, node_name="b0")
    db.phase = "Running"
    w.upsert_pod(db)
    for i in range(3):
        p = t.build_test_pod(f"w{i}", cpu_milli=3000, mem_mib=64,
                             labels={"app": "w"}, owner_name="w-rs")
        p.pod_affinity = [api.AffinityTerm(match_labels={"app": "db"},
                                           topology_key=ZONE)]
        w.upsert_pod(p)
    for i in range(4):
        p = t.build_test_pod(f"s{i}", cpu_milli=500, mem_mib=64,
                             labels={"app": "s"}, owner_name="s-rs")
        p.topology_spread = [api.TopologySpreadConstraint(
            max_skew=1, topology_key=ZONE, match_labels={"app": "s"})]
        w.upsert_pod(p)
    return w


ZONE_NGS = [
    {"id": f"ng-{z}", "max_new": 8, "price": 1.0 + (z == "b"),
     "template": {"name": f"tmpl-{z}", "labels": {ZONE: z},
                  "capacity": {"cpu": 4.0, "memory": 8192 * MIB, "pods": 110}}}
    for z in ("a", "b")]


def _strip(resp):
    """A response without its timing block (lifecycle stamps and trace
    ids are observation, not decision)."""
    assert isinstance(resp, dict), resp
    return {k: v for k, v in resp.items() if k not in ("lifecycle", "trace")}


@pytest.fixture(scope="module")
def services():
    """One service of each package (4 batch lanes; the serial tier is the
    same object's `_scale_*_serial`), fed the same payloads."""
    out = {}
    for pkg in ("jax", "torch"):
        server = _mod(pkg, "sidecar.server")
        kw = {"device": "cpu"} if pkg == "torch" else {}
        svc = server.SimulatorService(node_bucket=16, group_bucket=16,
                                      pod_bucket=32, batch_lanes=4,
                                      batch_window_ms=30.0, **kw)
        acks = []
        for s, tid in enumerate(TENANTS):
            acks.append(svc.apply_delta(_world_writer(pkg, s).payload(),
                                        tenant=tid))
        acks.append(svc.apply_delta(_churn_writer(pkg, 1).payload(),
                                    tenant="t1"))
        acks.append(svc.apply_delta(_constrained_writer(pkg).payload(),
                                    tenant="c"))
        out[pkg] = (server, svc, acks)
    yield out
    for _server, svc, _acks in out.values():
        svc.close()


def _fan(svc, method: str, params, tenants) -> dict:
    """One request per tenant from its own thread, so the window coalesces
    them into one batched dispatch."""
    got, errs = {}, []
    barrier = threading.Barrier(len(tenants))

    def run(tid):
        try:
            barrier.wait()
            got[tid] = getattr(svc, method)(params, tenant=tid)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in tenants]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert not errs, errs
    return got


# ---- the codec ------------------------------------------------------------

def test_codec_source_and_goldens_are_the_references_bytes():
    ref = ROOT / REF / "sidecar"
    port = ROOT / PORT
    assert (port / "csrc" / "host" / "kacodec.cc").read_bytes() == \
        (ref / "native" / "kacodec.cc").read_bytes()
    names = sorted(p.name for p in (ref / "goldens").iterdir())
    assert names == sorted(p.name for p in (port / "sidecar" / "goldens")
                           .iterdir())
    for name in names:
        assert (port / "sidecar" / "goldens" / name).read_bytes() == \
            (ref / "goldens" / name).read_bytes(), name


def test_fold32_batch_equals_the_references():
    strings = [b"", b"a", b"app=web", "zone=é".encode(), b"x" * 300,
               b"kubernetes.io/hostname\x00n1"]
    ref = _mod("jax", "sidecar.native_api").fold32_batch(strings)
    got = _mod("torch", "sidecar.native_api").fold32_batch(strings)
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


def _exports(st, rung=(16, 16, 32)):
    n, g, p = st.export(*rung)
    return {f"{sec}.{k}": v for sec, d in (("nodes", n), ("groups", g),
                                           ("pods", p)) for k, v in d.items()}


def test_delta_sequence_exports_byte_equal():
    """Upserts, then an update, a deleted resident and node, a new node in
    the freed slot and a cordon: after each payload the port's numpy
    exports equal the JAX codec's by dtype, shape and bytes."""
    states = {pkg: _mod(pkg, "sidecar.native_api").NativeSnapshotState()
              for pkg in PKG}
    for step in range(3):
        for pkg, st in states.items():
            w = (_world_writer(pkg, 5) if step == 0 else
                 _churn_writer(pkg, 5) if step == 1 else
                 _world_writer(pkg, 6, n_nodes=3, n_pending=4))
            st.apply_delta(w.payload())
        ref, got = states["jax"], states["torch"]
        assert got.version == ref.version == step + 1
        assert got.counts() == ref.counts()
        assert got.section_versions() == ref.section_versions()
        assert got.num_zones() == ref.num_zones()
        assert [got.group_key(r) for r in range(8)] == \
            [ref.group_key(r) for r in range(8)]
        e_ref, e_got = _exports(ref), _exports(got)
        assert e_ref.keys() == e_got.keys()
        for k, a in e_ref.items():
            b = e_got[k]
            assert (a.dtype, a.shape) == (b.dtype, b.shape), k
            assert a.tobytes() == b.tobytes(), f"step {step}: {k}"


def test_bad_payload_is_refused_as_the_reference_refuses_it():
    errs = {}
    for pkg in PKG:
        st = _mod(pkg, "sidecar.native_api").NativeSnapshotState()
        with pytest.raises(ValueError) as e:
            st.apply_delta(b"KAD1\x05\x00\x00\x00\x01\x02")
        errs[pkg] = str(e.value)
        assert st.version == 0
    assert errs["torch"] == errs["jax"]


def test_to_tensors_on_the_cpu_matches_the_export():
    st = _mod("torch", "sidecar.native_api").NativeSnapshotState()
    st.apply_delta(_world_writer("torch", 2).payload())
    nt, gt, pt = st.to_tensors(16, 16, 32, device="cpu")
    nodes, groups, pods = st.export(16, 16, 32)
    assert nt.cap.device.type == "cpu"
    np.testing.assert_array_equal(nt.cap.numpy(), nodes["cap"])
    np.testing.assert_array_equal(nt.valid.numpy(), nodes["valid"] > 0)
    np.testing.assert_array_equal(gt.count.numpy(), groups["count"])
    np.testing.assert_array_equal(pt.movable.numpy(), pods["movable"] > 0)
    assert nt.valid.dtype == torch.bool and gt.req.dtype == torch.int32


@pytest.mark.parametrize("name", ["aux_constraints", "equivalence_and_alloc",
                                  "incremental_sequence", "nodes_fields",
                                  "pods_fields"])
def test_committed_golden_replays_through_the_ports_codec(name):
    conf = _mod("torch", "sidecar.conformance")
    g = np.load(Path(conf.GOLDEN_DIR) / f"{name}.npz")
    payloads = []
    while f"payload_{len(payloads)}" in g:
        payloads.append(g[f"payload_{len(payloads)}"].tobytes())
    st, (nodes, groups, pods) = conf.replay(payloads)
    n, p, grp = st.counts()
    assert [n, p, grp, st.version] == g["counts"].tolist()
    for section, got in (("nodes", nodes), ("groups", groups),
                         ("pods", pods)):
        for field, arr in got.items():
            want = g[f"{section}.{field}"]
            assert arr.dtype == want.dtype and np.array_equal(arr, want), \
                f"{name}: {section}.{field}"
    # the port's writer produces the committed bytes too
    for (sname, writers, _d) in conf.scenarios():
        if sname == name:
            for i, w in enumerate(writers):
                assert w.payload() == g[f"payload_{i}"].tobytes()


# ---- the batched variants --------------------------------------------------

@pytest.fixture(scope="module")
def lane_worlds():
    """Four port tenants' class-shaped worlds as the service stacks them."""
    api = _mod("torch", "sidecar.native_api")
    b = _mod("torch", "sidecar.batch")
    server = _mod("torch", "sidecar.server")
    svc = server.SimulatorService(node_bucket=16, group_bucket=16,
                                  pod_bucket=32, device="cpu")
    worlds = []
    for s in range(4):
        st = api.NativeSnapshotState()
        st.apply_delta(_world_writer("torch", 10 + s,
                                     n_nodes=6 + 2 * s).payload())
        ts = svc._tenant(f"w{s}")
        ts.state = st
        ng, ids, _r, _d, ng_dev = svc._ng_np(ts, server.SimParams(
            node_groups=NGS))
        nodes, groups, pods = (st.export_nodes(16), st.export_groups(16),
                               st.export_pods(32))
        worlds.append(dict(up=b.UpLane(nodes=nodes, groups=groups, pods=pods,
                                       ng=ng, ids=ids),
                           down=b.DownLane(nodes=nodes, groups=groups,
                                           pods=pods, threshold=0.3 + 0.1 * s)))
    svc.close()
    return worlds


def _leaves(tree):
    out = []
    for t in tree:
        _mod("torch", "ops.autoscale_step")._map(out.append, t)
    return out


def _tree_lane(tree, i):
    a = _mod("torch", "ops.autoscale_step")
    return a._lane(tree, i)


def _assert_same(got, want, ctx):
    from torch_parity import leaves

    lg, lw = leaves(got), leaves(want)
    assert lg.keys() == lw.keys(), ctx
    for k in lw:
        assert (lg[k].dtype, lg[k].shape) == (lw[k].dtype, lw[k].shape), \
            (ctx, k)
        assert lg[k].tobytes() == lw[k].tobytes(), (ctx, k)


def _serial_up(ln):
    a = _mod("torch", "ops.autoscale_step")
    b = _mod("torch", "sidecar.batch")
    dims = _mod("torch", "models.cluster_state").DEFAULT_DIMS
    return a.scale_up_sim(b.node_tensors(ln.nodes, "cpu"),
                          b.podgroup_tensors(ln.groups, "cpu"),
                          b.sched_tensors(ln.pods, "cpu"),
                          b.nodegroup_tensors(ln.ng, "cpu"), dims, 16,
                          "least-waste")


def _serial_down(ln):
    a = _mod("torch", "ops.autoscale_step")
    b = _mod("torch", "sidecar.batch")
    return a.scale_down_sim(b.node_tensors(ln.nodes, "cpu"),
                            b.podgroup_tensors(ln.groups, "cpu"),
                            b.sched_tensors(ln.pods, "cpu"),
                            np.float32(ln.threshold).item())


@pytest.mark.parametrize("order", [(0, 1, 2, 3), (2, 0, 3, 1)])
def test_batched_equals_serial_lane_for_lane(lane_worlds, order):
    """Lane i of each batched sim is the serial sim of lane i's world, in
    any tenant order."""
    a = _mod("torch", "ops.autoscale_step")
    b = _mod("torch", "sidecar.batch")
    dims = _mod("torch", "models.cluster_state").DEFAULT_DIMS
    ups = [lane_worlds[i]["up"] for i in order]
    downs = [lane_worlds[i]["down"] for i in order]
    stacked = b.stack_up_lanes(ups, "cpu")
    before = [(x.clone(), x._version) for x in _leaves(stacked)]
    out = a.scale_up_sim_batch(*stacked, dims, 16, "least-waste")
    for lane, ln in enumerate(ups):
        _assert_same(_tree_lane(out, lane), _serial_up(ln), ("up", lane))
    nt, gt, pt, th = b.stack_down_lanes(downs, "cpu")
    assert th.dtype == torch.float32 and th.shape == (4,)
    out = a.scale_down_sim_batch(nt, gt, pt, th)
    for lane, ln in enumerate(downs):
        _assert_same(_tree_lane(out, lane), _serial_down(ln), ("down", lane))
    # a cached stack is reused by the next window: the sims leave it as
    # they found it
    for (x0, v0), x in zip(before, _leaves(stacked)):
        assert x._version == v0 and torch.equal(x, x0)


def test_padded_lanes_equal_computing_every_lane(lane_worlds):
    """A window of 2 members padded to 4 lanes (lane 0 repeated): with
    `members=2` the padded lanes get lane 0's outputs uncomputed, and the
    whole tree equals computing all 4 lanes; members equal the serial
    sims."""
    a = _mod("torch", "ops.autoscale_step")
    b = _mod("torch", "sidecar.batch")
    dims = _mod("torch", "models.cluster_state").DEFAULT_DIMS
    ups = b.pad_lanes([w["up"] for w in lane_worlds[1:3]], 4)
    downs = b.pad_lanes([w["down"] for w in lane_worlds[1:3]], 4)
    assert ups[2] is ups[0] and ups[3] is ups[0]
    stacked = b.stack_up_lanes(ups, "cpu")
    every = a.scale_up_sim_batch(*stacked, dims, 16, "least-waste")
    padded = a.scale_up_sim_batch(*stacked, dims, 16, "least-waste",
                                  members=2)
    _assert_same(padded, every, "up")
    for lane in range(4):
        _assert_same(_tree_lane(padded, lane), _serial_up(ups[lane]),
                     ("up", lane))
    nt, gt, pt, th = b.stack_down_lanes(downs, "cpu")
    every = a.scale_down_sim_batch(nt, gt, pt, th)
    padded = a.scale_down_sim_batch(nt, gt, pt, th, members=2)
    _assert_same(padded, every, "down")
    for lane in range(4):
        _assert_same(_tree_lane(padded, lane), _serial_down(downs[lane]),
                     ("down", lane))
    with pytest.raises(ValueError):
        a.scale_up_sim_batch(*stacked, dims, 16, "least-waste", members=5)


# ---- the services ----------------------------------------------------------

def test_apply_delta_acks_equal(services):
    assert services["torch"][2] == services["jax"][2]
    assert [a["error"] for a in services["torch"][2]] == [""] * 5


def test_batched_scale_up_and_down_equal_the_jax_service(services):
    """Three tenants per window on each package's batched tier: every
    member's response equals the JAX service's, and equals the serial
    tier's on the same service."""
    for method, params in (
            ("scale_up_sim", dict(node_groups=NGS, max_new_nodes=16)),
            ("scale_down_sim", dict(threshold=0.45))):
        got = {}
        for pkg, (server, svc, _acks) in services.items():
            got[pkg] = _fan(svc, method, server.SimParams(**params), TENANTS)
            # the serial tier of the same service answers the same
            for tid in TENANTS:
                ts = svc._tenant(tid)
                serial = getattr(svc, f"_{method}_serial".replace(
                    "_sim_serial", "_serial"))(ts, server.SimParams(**params))
                assert _strip(serial) == _strip(got[pkg][tid]), (pkg, tid)
        for tid in TENANTS:
            assert _strip(got["torch"][tid]) == _strip(got["jax"][tid]), \
                (method, tid)
    assert services["torch"][1].batch_stats()["batches"] >= 2


def test_constrained_tenant_routes_serial_and_equals_the_jax_service(
        services):
    resp = {}
    for pkg, (server, svc, _acks) in services.items():
        ts = svc._tenant("c")
        assert ts.aux and not svc._batchable(ts)
        before = svc.batch_stats()["batches"]
        up = svc.scale_up_sim(server.SimParams(
            node_groups=ZONE_NGS, max_new_nodes=8, strategy="most-pods"),
            tenant="c")
        down = svc.scale_down_sim(server.SimParams(threshold=0.6),
                                  tenant="c")
        assert svc.batch_stats()["batches"] == before
        # the what-if lanes carry no constraint overlay: both refuse
        admission = _mod(pkg, "sidecar.admission")
        with pytest.raises(admission.WorldValidationError) as e:
            svc.what_if(json.dumps({"node_groups": ZONE_NGS}).encode(),
                        tenant="c")
        resp[pkg] = (_strip(up), _strip(down), e.value.reason)
    assert resp["torch"] == resp["jax"]
    assert resp["torch"][2] == "whatif-constrained"
    # the zone affinity keeps the pod that fits nowhere out of zone a
    up = resp["torch"][0]
    by_id = {o["id"]: o for o in up["options"]}
    assert up["best"] == "ng-b" and by_id["ng-a"]["pods"] == 0, up


def test_what_if_equals_the_jax_service(services):
    body = json.dumps({
        "node_groups": NGS, "max_new_nodes": 16,
        "variants": [{"name": "half-price", "price_scale": 0.5},
                     {"name": "capped", "max_new_cap": 0},
                     {"name": "reclaim", "fail_nodes": [1]}],
        "rollout": 2, "workload": {"v": 1, "kind": "quiet"}}).encode()
    got = {pkg: _strip(svc.what_if(body, tenant="t1"))
           for pkg, (_s, svc, _a) in services.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"]["lanes"] == 4 and got["torch"]["rollout"]["steps"] == 2


def test_new_tenant_in_a_warm_class_costs_no_build(services):
    server, svc, _acks = services["torch"]
    # warm: the class of t0 has served; a fifth tenant lands in it
    svc.scale_up_sim(server.SimParams(node_groups=NGS, max_new_nodes=16),
                     tenant="t0")
    assert svc.apply_delta(_world_writer("torch", 0).payload(),
                           tenant="late")["error"] == ""
    assert svc._tenant("late").shape_class == svc._tenant("t0").shape_class
    svc.scale_up_sim(server.SimParams(node_groups=NGS, max_new_nodes=16),
                     tenant="late")
    assert svc.batch_stats()["recompiles_per_new_tenant"] == 0
    assert svc._tenant("late").dispatched


def test_service_and_codec_tensors_need_a_device(monkeypatch):
    server = _mod("torch", "sidecar.server")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        server.SimulatorService()
    st = _mod("torch", "sidecar.native_api").NativeSnapshotState()
    with pytest.raises(RuntimeError, match="CUDA"):
        st.to_tensors()
    with pytest.raises(RuntimeError, match="CUDA"):
        _mod("torch", "sidecar.batch").node_tensors(st.export_nodes())


def test_shadow_audit_re_runs_a_lane_serially_without_divergence():
    """The online audit re-simulates one member of each window through the
    serial sims (server._audit_reference, one fetch) and finds the batched
    verdict equal."""
    server = _mod("torch", "sidecar.server")
    svc = server.SimulatorService(node_bucket=16, group_bucket=16,
                                  pod_bucket=32, batch_lanes=2,
                                  batch_window_ms=30.0, shadow_audit=True,
                                  device="cpu")
    try:
        for s, tid in enumerate(("a", "b")):
            svc.apply_delta(_world_writer("torch", 20 + s).payload(),
                            tenant=tid)
        _fan(svc, "scale_up_sim", server.SimParams(node_groups=NGS,
                                                   max_new_nodes=16),
             ("a", "b"))
        _fan(svc, "scale_down_sim", server.SimParams(threshold=0.45),
             ("a", "b"))
        assert svc.audit_quiesce(timeout_s=60)
        stats = svc.audit_stats()
        assert stats["divergences"] == 0, stats
        assert stats["checks"].get("sidecar-up/ok", 0) >= 1, stats
        assert stats["checks"].get("sidecar-down/ok", 0) >= 1, stats
    finally:
        svc.close()

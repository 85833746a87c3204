"""The port's control loop (`core/static_autoscaler.StaticAutoscaler`)
against the JAX package's, loop for loop, on the CPU.

Lockstep twins: each package builds the same seeded world with its own
FakeCluster, build_test_node and build_test_pod, and the same churn script
runs against both autoscalers: pod churn, an unfittable burst that scales
up, scale-down actuation (unneeded time 0). Every loop must give the same
decision-surface digests (each package's own `replay/journal.
collect_outputs` + `surface_digests`), the same `fused_mode`, speculation
outcome and device round trips.

Also pinned here: the port's fused loop equals its phased loop; a churned
plane discards an armed speculation through the identity gate and a steady
world harvests one; the compile census does not grow after the first
loop; the features the port has not got raise NotImplementedError naming
their ROADMAP item, and a constrained world does not; and the module-level pieces the loop rides — the
world store under fuzzed churn, the reason planes, `failure_reasons`,
`AsyncFetch`, the encode seam that must copy (never alias) host arrays,
the snapshot's verbs, and the device observability (compile census, HBM
ledger, profiler capture, supervisor probe).
"""

from __future__ import annotations

import dataclasses
import importlib
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import PORT, REF, build_world, encode_world

PKG = {"jax": REF, "torch": PORT}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The worlds here are tiny: one intra-op thread is enough, and keeps
    this file from crowding the other test workers' cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{PKG[pkg]}.{name}")


def _world(pkg: str, n_nodes: int = 12, n_pending: int = 6, seed: int = 0):
    """test_fused_loop._world's shape, built with `pkg`'s own objects."""
    t = _mod(pkg, "utils.testing")
    fake = _mod(pkg, "utils.fakecluster").FakeCluster()
    rng = np.random.RandomState(seed)
    tmpl = t.build_test_node("tmpl", cpu_milli=4000, mem_mib=8192)
    fake.add_node_group("ng1", tmpl, min_size=0, max_size=20)
    for i in range(n_nodes):
        nd = t.build_test_node(f"n{i}", cpu_milli=4000, mem_mib=8192)
        fake.add_existing_node("ng1", nd)
        if i % 2 == 0:
            fake.add_pod(t.build_test_pod(
                f"r{i}", cpu_milli=int(rng.choice([800, 1600, 2400])),
                mem_mib=512, owner_name=f"rs{i % 3}", node_name=nd.name))
    for i in range(n_pending):
        fake.add_pod(t.build_test_pod(f"p{i}", cpu_milli=300, mem_mib=256,
                                      owner_name="prs"))
    return fake


def _autoscaler(pkg: str, fake, unneeded_s: float = 0.0, **kw):
    o = _mod(pkg, "config.options")
    base = dict(
        scale_down_delay_after_add_s=0.0,
        scale_down_delay_after_failure_s=0.0,
        node_shape_bucket=16, group_shape_bucket=16,
        max_new_nodes_static=32, max_pods_per_node=32, drain_chunk=8,
        node_group_defaults=o.NodeGroupDefaults(
            scale_down_unneeded_time_s=unneeded_s,
            scale_down_unready_time_s=3600.0),
    )
    base.update(kw)
    extra = {"device": "cpu"} if pkg == "torch" else {}
    a = _mod(pkg, "core.static_autoscaler").StaticAutoscaler(
        fake.provider, fake, options=o.AutoscalingOptions(**base),
        eviction_sink=fake, registry=_mod(pkg, "metrics.metrics").Registry(),
        **extra)
    a.capture_verdicts = True
    return a


def _churn(pkg: str, fake, loop: int) -> None:
    """The script: pod churn every third loop, an unfittable burst on loop
    4 (a real scale-up), more pending load on loop 6."""
    t = _mod(pkg, "utils.testing")
    if loop % 3 == 1:
        seq = loop // 3
        fake.remove_pod(f"p{seq % 6}")
        fake.add_pod(t.build_test_pod(f"p{6 + seq}", cpu_milli=300,
                                      mem_mib=256, owner_name="prs"))
    if loop == 4:
        fake.add_pod(t.build_test_pod("burst", cpu_milli=3900, mem_mib=512,
                                      owner_name="bg"))
    if loop == 6:
        for k in range(3):
            fake.add_pod(t.build_test_pod(f"q{k}", cpu_milli=1200,
                                          mem_mib=256, owner_name="qrs"))


def _surfaces(pkg: str, a, st) -> dict:
    rj = _mod(pkg, "replay.journal")
    return {"digests": rj.surface_digests(rj.collect_outputs(a, st)),
            "fused_mode": st.fused_mode, "speculation": st.speculation,
            "round_trips": st.loop_device_round_trips}


def _lockstep(loops: int = 9, **kw):
    """Both packages through the script; returns per-loop surfaces."""
    out = {}
    for pkg in ("jax", "torch"):
        fake = _world(pkg)
        a = _autoscaler(pkg, fake, **kw)
        rows = []
        for loop in range(loops):
            _churn(pkg, fake, loop)
            st = a.run_once(now=1000.0 + 10 * loop)
            rows.append((_surfaces(pkg, a, st), st))
        out[pkg] = rows
    return out


@pytest.mark.parametrize("incremental", [True, False],
                         ids=["incremental", "full-encode"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "phased"])
def test_loop_matches_jax_loop_for_loop(fused, incremental):
    runs = _lockstep(fused_loop=fused, incremental_encode=incremental)
    deleted = scaled_up = 0
    for loop, ((ref, _), (got, st)) in enumerate(zip(runs["jax"],
                                                      runs["torch"])):
        assert got == ref, (loop, ref, got)
        assert st.fused_mode == ("fused" if fused else "phased")
        deleted += len(st.scale_down_deleted)
        scaled_up += bool(st.scale_up is not None and st.scale_up.scaled_up)
    # the script really exercised both directions
    assert deleted > 0 and scaled_up > 0


def test_fused_loop_equals_phased_loop():
    """The port's own oracle: the fused single-dispatch loop decides
    exactly what the phased ladder decides, loop for loop."""
    rows = {}
    for fused in (True, False):
        fake = _world("torch", seed=3)
        a = _autoscaler("torch", fake, unneeded_s=3600.0, fused_loop=fused)
        rows[fused] = []
        for loop in range(8):
            _churn("torch", fake, loop)
            st = a.run_once(now=1000.0 + 10 * loop)
            rows[fused].append(_surfaces("torch", a, st)["digests"])
    assert rows[True] == rows[False]


def test_steady_world_harvests_speculation_and_census_stays_flat():
    """Loop 1 re-uploads the node planes the first (full) encode seeded
    and discards, as the JAX loop does; from then on a world that does not
    change harvests every speculation: the harvest plus the planner's
    candidate-subset fetch, two round trips a loop."""
    fake = _world("torch")
    a = _autoscaler("torch", fake, unneeded_s=3600.0)
    st = a.run_once(now=1000.0)
    assert st.speculation == "none" and a._speculation is not None
    compiles = a._fused_cache_size
    st = a.run_once(now=1010.0)
    assert st.speculation == "discard"
    for loop in range(2, 5):
        st = a.run_once(now=1000.0 + 10 * loop)
        assert st.speculation == "hit", loop
        assert st.loop_device_round_trips == 2, loop
    assert a._fused_cache_size == compiles
    assert a.metrics.counter("fused_program_compiles_total").value() == 0.0
    assert a.metrics.counter("speculative_hits_total").value() == 3.0


def test_churned_plane_discards_speculation_through_identity_gate():
    """A patched world plane is a NEW tensor (out-of-place index_copy), so
    the harvest gate's `is` check discards a speculation even when the
    composition key is made to match."""
    fake = _world("torch")
    a = _autoscaler("torch", fake, unneeded_s=3600.0)
    a.run_once(now=1000.0)
    a.run_once(now=1005.0)
    spec = a._speculation
    assert spec is not None
    # the key cannot tell: pin the fingerprint so only the gate decides
    a._world_store.composition_fingerprint = lambda nodes, pods: "pinned"
    spec["key"] = ("pinned", spec["key"][1])
    before = {k: v for k, v in a._world_store.device_store.token().items()}
    t = _mod("torch", "utils.testing")
    fake.add_pod(t.build_test_pod("churn", cpu_milli=300, mem_mib=256,
                                  owner_name="prs"))
    st = a.run_once(now=1010.0)
    assert st.speculation == "discard"
    after = a._world_store.device_store.token()
    patched = [k for k in before if after[k] is not before[k]]
    assert "specs.count" in patched
    # the replaced plane was not written in place
    old = before["specs.count"]
    assert not torch.equal(old, after["specs.count"])


def test_world_store_scatter_is_out_of_place():
    ws = _mod("torch", "models.world_store")
    store = ws.DevicePlaneStore("cpu")
    mirror = np.arange(64, dtype=np.int32).reshape(16, 4)
    store.seed({"k": torch.from_numpy(mirror.copy())})
    first = store.upload("k", mirror)
    mirror[3] = -1
    store.mark("k", 3)
    second = store.upload("k", mirror)
    assert second is not first
    assert first[3].tolist() == [12, 13, 14, 15]
    assert second[3].tolist() == [-1] * 4
    assert store._actions["k"][0] == "scatter"
    # a cached plane keeps its identity
    store.finish_loop()
    assert store.upload("k", mirror) is second


@pytest.mark.parametrize("option, value, item", [
    ("shadow_audit", True, "ROADMAP A10"),
    ("journal_dir", "journal-x", "ROADMAP A2"),
    ("async_node_group_creation", True, "ROADMAP A11"),
    ("grpc_expander_url", "localhost:1", "ROADMAP A11"),
])
def test_unported_option_raises(option, value, item):
    fake = _world("torch")
    kw = {option: value}
    if option == "grpc_expander_url":
        kw["expander"] = "grpc"
    with pytest.raises(NotImplementedError, match=item):
        _autoscaler("torch", fake, **kw)


def test_mesh_and_constrained_world_raise():
    """A mesh on the orchestrator still raises (ROADMAP A9); a world with
    topology-coupled constraints no longer does: the constrained tier is
    ported, and the loop stays fused on it."""
    fake = _world("torch")
    a = _autoscaler("torch", fake)
    a.scale_up_orchestrator.mesh = object()
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        a.run_once(now=1000.0)
    api = _mod("torch", "models.api")
    t = _mod("torch", "utils.testing")
    fake = _world("torch")
    p = t.build_test_pod("spread", cpu_milli=300, mem_mib=256,
                         owner_name="sp", labels={"app": "s"})
    p.anti_affinity = [api.AffinityTerm(match_labels={"app": "s"},
                                        topology_key="kubernetes.io/hostname")]
    fake.add_pod(p)
    for incremental in (True, False):
        a = _autoscaler("torch", fake, incremental_encode=incremental)
        st = a.run_once(now=1000.0)
        assert st.fused_mode == "fused"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fake = _world("torch")
    sa = _mod("torch", "core.static_autoscaler")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sa.StaticAutoscaler(fake.provider, fake)


# ------------------------------------------------------------ module pieces


class _FuzzWorld:
    """tests/test_incremental_encode._World's churn, built with one
    package's objects (the same rng gives both packages the same world)."""

    def __init__(self, pkg: str, rng):
        self.api = _mod(pkg, "models.api")
        self.t = _mod(pkg, "utils.testing")
        self.rng = rng
        self.nodes, self.pods, self.pdbs = {}, {}, set()
        self.n_seq = self.p_seq = 0

    def add_node(self):
        r, api = self.rng, self.api
        self.n_seq += 1
        nd = self.t.build_test_node(
            f"n{self.n_seq}", cpu_milli=r.choice([4000, 8000]),
            mem_mib=8192, pods=32,
            labels={"pool": r.choice(["a", "b"]),
                    "disk": r.choice(["ssd", "hdd"])},
            taints=[api.Taint("dedicated", "infra", "NoSchedule")]
            if r.random() < 0.25 else [],
            zone=r.choice(["z1", "z2", "z3"]), ready=r.random() > 0.1)
        self.nodes[nd.name] = nd

    def make_pod(self, node_name=""):
        r, api = self.rng, self.api
        self.p_seq += 1
        p = self.t.build_test_pod(
            f"p{self.p_seq}", cpu_milli=r.choice([100, 500, 1000]),
            mem_mib=r.choice([64, 512]),
            namespace=r.choice(["default", "kube-system", "apps"]),
            node_name=node_name, labels={"app": r.choice(["web", "api"])},
            node_selector={"disk": "ssd"} if r.random() < 0.3 else None,
            tolerations=[api.Toleration(key="dedicated", operator="Equal",
                                        value="infra", effect="NoSchedule")]
            if r.random() < 0.3 else None,
            owner_kind=r.choice(["ReplicaSet", "Job", "CustomThing"]),
            owner_name=f"rs{r.randint(0, 5)}",
            host_port=8080 if r.random() < 0.15 else 0)
        if r.random() < 0.15:
            p.topology_spread = [api.TopologySpreadConstraint(
                max_skew=r.choice([1, 2]),
                topology_key="topology.kubernetes.io/zone",
                match_labels={"app": "web"})]
        return p

    def step(self):
        r = self.rng
        op = r.random()
        node_names, pod_names = list(self.nodes), list(self.pods)
        if op < 0.35:
            nn = r.choice(node_names) if node_names and r.random() < 0.6 \
                else ""
            p = self.make_pod(nn)
            self.pods[p.name] = p
        elif op < 0.5 and pod_names:
            del self.pods[r.choice(pod_names)]
        elif op < 0.62 and pod_names:           # rebind in place
            p = self.pods[r.choice(pod_names)]
            p.node_name = r.choice(node_names) if node_names else ""
        elif op < 0.72 and pod_names:           # replace with a changed spec
            old = self.pods[r.choice(pod_names)]
            self.pods[old.name] = dataclasses.replace(
                old, labels={**old.labels, "app": r.choice(["web", "db"])})
        elif op < 0.8 and node_names:           # taint flip (new object)
            old = self.nodes[r.choice(node_names)]
            self.nodes[old.name] = dataclasses.replace(
                old, taints=[] if old.taints else
                [self.api.Taint("dedicated", "infra", "NoSchedule")])
        elif op < 0.86:
            self.add_node()
        elif op < 0.9 and len(node_names) > 3:
            gone = r.choice(node_names)
            del self.nodes[gone]
            for p in self.pods.values():
                if p.node_name == gone:
                    p.node_name = ""
        elif pod_names:
            nm = r.choice(pod_names)
            p = self.pods[nm]
            key = f"{p.namespace}/{p.name}"
            self.pdbs.symmetric_difference_update({key})

    def lists(self):
        return list(self.nodes.values()), list(self.pods.values())


@pytest.mark.parametrize("seed", [5, 6])
def test_world_store_delta_planes_match_full_encode_both_packages(seed):
    """The reference's fuzzed-churn world-store property, run by both
    packages in lockstep: every loop each resident plane equals its host
    mirror bit for bit and the encoding equals a cold full encode; the two
    packages' mirrors are identical (plane digests) and so are their
    encode modes; one full encode ever."""
    stores, worlds = {}, {}
    for pkg in ("jax", "torch"):
        rng = random.Random(seed)
        worlds[pkg] = _FuzzWorld(pkg, rng)
        for _ in range(6):
            worlds[pkg].add_node()
        for _ in range(12):
            worlds[pkg].step()
        kw = {"device": "cpu"} if pkg == "torch" else {}
        stores[pkg] = _mod(pkg, "models.world_store").WorldStore(
            registry=_mod(pkg, "metrics.metrics").Registry(),
            node_bucket=16, group_bucket=8, pod_bucket=16,
            drain_opts=_mod(pkg, "simulator.drainability.rules")
            .DrainOptions(), **kw)
    now = 1000.0
    for step in range(16):
        modes = {}
        for pkg in ("jax", "torch"):
            w, store = worlds[pkg], stores[pkg]
            if step:
                for _ in range(w.rng.randint(1, 4)):
                    w.step()
            nodes, pods = w.lists()
            enc = store.encode(nodes, pods, now=now,
                               pdb_namespaced_names=frozenset(w.pdbs))
            modes[pkg] = (store.last_mode, store.last_cause,
                          store.last_h2d_bytes)
            devs = store.device_store.token()
            for key, mirror in store.encoder._m.items():
                dev = devs[key]
                host = (dev.numpy() if isinstance(dev, torch.Tensor)
                        else np.asarray(dev))
                assert np.array_equal(host, mirror), (pkg, step, key)
            enc_mod = _mod(pkg, "models.encode")
            fresh = enc_mod.encode_cluster(
                nodes, pods, registry=store.encoder.registry,
                node_bucket=16, group_bucket=8, pod_bucket=16,
                **({"device": "cpu"} if pkg == "torch" else {}))
            _mod(pkg, "simulator.drainability.rules").apply_drainability(
                fresh, now=now, pdb_namespaced_names=frozenset(w.pdbs))
            diff = _mod(pkg, "models.incremental").semantic_diff(enc, fresh)
            assert diff is None, (pkg, step, diff)
        assert modes["jax"] == modes["torch"], (step, modes)
        assert (stores["jax"].plane_digests()
                == stores["torch"].plane_digests()), step
        now += 10.0
    assert stores["torch"].encoder.full_encodes == 1


def test_encode_copies_host_arrays_at_the_device_seam():
    """On the CPU a tensor made by `torch.from_numpy(v).to("cpu")` would
    alias `v`: an in-place mirror edit would then silently update the
    "device" plane, hiding a missed dirty-row mark. Every seam copies."""
    enc, _ = encode_world(PORT, build_world(PORT, n_nodes=8), device="cpu")
    before = enc.nodes.alloc.clone()
    enc.host_arrays["nodes.alloc"][:] += 7
    assert torch.equal(enc.nodes.alloc, before)
    ws = _mod("torch", "models.world_store")
    mirror = np.zeros((4, 2), np.int32)
    plane = ws.to_device(mirror, "cpu")
    mirror[0, 0] = 9
    assert int(plane[0, 0]) == 0
    store = _mod("torch", "models.world_store").WorldStore(
        device="cpu", node_bucket=16, group_bucket=8, pod_bucket=16)
    nodes, pods, _t = build_world(PORT, n_nodes=8)
    e = store.encode(nodes, pods, now=0.0)
    snap = e.nodes.cap.clone()
    store.encoder._m["nodes.cap"][:] += 1
    assert torch.equal(e.nodes.cap, snap)


@pytest.mark.parametrize("check_resources", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_reason_planes_equal_jax(seed, check_resources):
    ref_enc, ref_groups = encode_world(REF, build_world(REF, seed=seed))
    port_enc, port_groups = encode_world(
        PORT, build_world(PORT, seed=seed), device="cpu")
    rp = _mod("jax", "ops.predicates")
    pp = _mod("torch", "ops.predicates")
    ref = np.asarray(rp.reason_mask(ref_enc.nodes, ref_enc.specs,
                                    check_resources=check_resources))
    got = pp.reason_mask(port_enc.nodes, port_enc.specs,
                         check_resources=check_resources).numpy()
    assert ref.dtype == got.dtype == np.uint16
    assert ref.tobytes() == got.tobytes()
    feas = pp.feasibility_mask(port_enc.nodes, port_enc.specs,
                               check_resources=check_resources).numpy()
    assert np.array_equal(feas, got == 0)
    refused = np.zeros((ref_enc.specs.g,), bool)
    refused[::2] = True
    dims_r = _mod("jax", "models.cluster_state").Dims()
    dims_p = _mod("torch", "models.cluster_state").Dims()
    ref_g = np.asarray(rp.reason_mask_for_groups(
        ref_groups.as_node_tensors(dims_r), ref_enc.specs,
        jnp.asarray(refused), check_resources=check_resources))
    got_g = pp.reason_mask_for_groups(
        port_groups.as_node_tensors(dims_p), port_enc.specs,
        torch.from_numpy(refused), check_resources=check_resources).numpy()
    assert ref_g.dtype == got_g.dtype and ref_g.tobytes() == got_g.tobytes()
    # the estimator's on-demand pass over the refused groups
    ref_e = _mod("jax", "estimator.estimator").explain_refused_groups(
        ref_enc.specs, ref_groups, refused, dims_r)
    got_e = _mod("torch", "estimator.estimator").explain_refused_groups(
        port_enc.specs, port_groups, refused, dims_p)
    assert ref_e.tobytes() == got_e.tobytes()
    for gi in np.nonzero(refused)[0]:
        assert (rp.summarize_reason_row(ref_e[gi], np.asarray(ref_groups.valid))
                == pp.summarize_reason_row(got_e[gi],
                                           port_groups.valid.numpy()))


@pytest.mark.parametrize("seed", [0, 2])
def test_failure_reasons_equal_jax(seed):
    world_kw = dict(residents_per_node=4, n_nodes=16)
    ref_enc, _ = encode_world(REF, build_world(REF, seed=seed, **world_kw))
    port_enc, _ = encode_world(PORT, build_world(PORT, seed=seed, **world_kw),
                               device="cpu")
    n = ref_enc.nodes.n
    cand = np.arange(0, 16, dtype=np.int32)
    dest = np.ones((n,), bool)
    dest[1::3] = False
    rd = _mod("jax", "ops.drain")
    pd = _mod("torch", "ops.drain")
    ref = rd.failure_reasons(ref_enc.nodes, ref_enc.specs, ref_enc.scheduled,
                             jnp.asarray(cand), jnp.asarray(dest),
                             max_pods_per_node=16, chunk=8,
                             max_groups_per_node=2)
    got = pd.failure_reasons(port_enc.nodes, port_enc.specs,
                             port_enc.scheduled, torch.from_numpy(cand),
                             torch.from_numpy(dest), max_pods_per_node=16,
                             chunk=8, max_groups_per_node=2)
    for f in ("reason", "fail_group", "n_unplaced"):
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    codes = set(got.reason.tolist())
    assert len(codes) >= 2, codes
    # the sweep itself is unchanged by the shared code path
    rem = pd.simulate_removals(port_enc.nodes, port_enc.specs,
                               port_enc.scheduled, torch.from_numpy(cand),
                               torch.from_numpy(dest), max_pods_per_node=16,
                               chunk=8, max_groups_per_node=2)
    ref_rem = rd.simulate_removals(
        ref_enc.nodes, ref_enc.specs, ref_enc.scheduled, jnp.asarray(cand),
        jnp.asarray(dest), max_pods_per_node=16, chunk=8,
        max_groups_per_node=2)
    for f in ("drainable", "has_blocker", "n_moved", "n_failed",
              "dest_node", "pod_slot"):
        assert (np.asarray(getattr(ref_rem, f)).tobytes()
                == getattr(rem, f).numpy().tobytes()), f


def test_async_fetch_equals_fetch_pytree():
    hf = _mod("torch", "ops.hostfetch")
    g = torch.Generator().manual_seed(0)
    tree = {"b": torch.rand((37, 5), generator=g) > 0.5,
            "i": torch.randint(-9, 9, (11,), generator=g, dtype=torch.int32),
            "u": torch.randint(0, 900, (3, 4), generator=g).to(torch.uint16),
            "f": torch.rand((6,), generator=g),
            "nested": (torch.zeros((2,), dtype=torch.bool), 5, None)}
    hf.reset_round_trips()
    want = hf.fetch_pytree(tree)
    assert hf.round_trips() == 1
    h = hf.fetch_pytree_async(tree, trace=False)
    got = h.get()
    assert h.get() is got
    assert hf.round_trips() == 2
    for k in ("b", "i", "u", "f"):
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k
    assert got["nested"][1:] == (5, None)
    # host leaves: no transfer, no round trip
    host = {"a": np.arange(3)}
    assert hf.fetch_pytree_async(host).get() is host
    assert hf.round_trips() == 2


def test_snapshot_verbs_equal_jax():
    """TensorClusterSnapshot's mutation verbs (out-of-place row sets, node
    growth past the padded bucket, the placement charge) against the JAX
    package's on the same seeded world."""
    from torch_parity import assert_trees_equal

    out = {}
    for pkg in ("jax", "torch"):
        world = build_world(PKG[pkg], n_nodes=14, seed=4)
        kw = {"device": "cpu"} if pkg == "torch" else {}
        enc, _ = encode_world(PKG[pkg], world, **kw)
        snap = _mod(pkg, "simulator.snapshot").TensorClusterSnapshot(enc)
        t = _mod(pkg, "utils.testing")
        first = snap.state.nodes.cap
        for k in range(4):              # 14 + 4 > the 16-row bucket: growth
            snap.add_node(t.build_test_node(f"x{k}", cpu_milli=4000,
                                            mem_mib=8192, zone="zb"),
                          group_id=1, alloc_row=np.full((8,), 3, np.int64))
        snap.remove_node("n2")
        snap.set_unschedulable("n3")
        packed = snap.schedule_pending_on_existing()
        snap.apply_placement(packed.placed)
        if pkg == "torch":
            assert first.shape[0] == 16 and snap.state.nodes.cap is not first
        out[pkg] = (snap.state.nodes, snap.state.specs, packed)
    assert_trees_equal(out["jax"], out["torch"])


def test_device_observability_on_the_port(tmp_path, monkeypatch):
    """The compile census counts kernel-build-cache growth; the residency
    ledger tracks the world store's tensors (host-RSS fallback without a
    card); a profiler capture writes a torch.profiler trace; the supervisor
    probe is one tiny round trip on the loop's device."""
    dev = _mod("torch", "metrics.device")
    build = _mod("torch", "ops.kernels.build")
    reg = _mod("torch", "metrics.metrics").Registry()
    census = dev.CompileCensus(registry=reg)

    def compiles():
        monkeypatch.setitem(build._loaded, "fake.cu", object())
        return 7

    assert census.dispatch("f", compiles) == 7
    assert census.dispatch("f", compiles) == 7      # no growth the 2nd time
    (variant,) = census.variants()
    assert variant["compiles"] == 1
    assert reg.counter("compile_census_total").value(
        fn="f", shape_sig=variant["shape_sig"], tenant="default") == 1.0

    monkeypatch.setattr(dev, "LEDGER", None)
    ledger = dev.enable_ledger()
    store = _mod("torch", "models.world_store").WorldStore(
        device="cpu", node_bucket=16, group_bucket=8, pod_bucket=16)
    nodes, pods, _t = build_world(PORT, n_nodes=8)
    enc = store.encode(nodes, pods, now=0.0)
    rec = ledger.reconcile(registry=reg)
    assert rec["source"] == "host-fallback"
    assert rec["by_owner_tenant"]["world_store/default"] == sum(
        int(t.nbytes) for t in store.device_store.token().values())
    del enc

    prof = dev.DeviceProfiler(str(tmp_path), min_interval_s=0.0)
    assert prof.arm("test", trace_id="t1")
    out, path = prof.capture(lambda: torch.arange(5).sum())
    assert int(out) == 10 and (tmp_path / "capture-000-t1" / "trace.json").exists()

    sup = _mod("torch", "core.supervisor")
    assert sup._default_probe("cpu") is True

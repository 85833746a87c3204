"""The port's constrained tier (ops/constrained.py and the constrained
branches of the filter pack, the estimate, the drain sweep and the steps)
against the JAX package's, on the CPU.

Each package builds and encodes the same seeded world with its own object
model and encoder. The world carries every dense constraint kind: zone and
hostname topology spread (maxSkew 1 and 2, selecting the group itself or
only residents), hostname and zone pod affinity (satisfied by residents, or
self-selecting with the first-pod bootstrap), hostname and zone
anti-affinity (to residents, and to itself, incl. one-per-zone), nodes and
a template without a zone, constrained residents the drain re-places, and a
group that runs into MAX_WAVES. A second world has more zones than the
dims hold, which the encoder turns lossy (host check). Int and bool leaves
are byte-equal; f32 leaves within rtol 1e-6.

Also here: the oracle property tests of the reference's
tests/test_constrained_pack.py, on the port's own utils/oracle.py, and the
wave-check interval pinned to change no output.
"""

from __future__ import annotations

import copy
import importlib
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import PORT, REF, assert_trees_equal, leaves

from kubernetes_autoscaler_tpu.models.cluster_state import (
    ClusterTensors as RefClusterTensors,
)
from kubernetes_autoscaler_tpu.ops import autoscale_step as ref_step
from kubernetes_autoscaler_tpu.ops import binpack as ref_binpack
from kubernetes_autoscaler_tpu.ops import constrained as ref_con
from kubernetes_autoscaler_tpu.ops import drain as ref_drain
from kubernetes_autoscaler_tpu.ops import predicates as ref_preds
from kubernetes_autoscaler_tpu.ops import schedule as ref_schedule
from kubernetes_autoscaler_tpu.ops.pack import ffd_order as ref_ffd_order
from kubernetes_autoscaler_tpu_torch.models.cluster_state import ClusterTensors
from kubernetes_autoscaler_tpu_torch.ops import (
    autoscale_step,
    binpack,
    constrained,
    drain,
    predicates,
    schedule,
)
from kubernetes_autoscaler_tpu_torch.ops.pack import ffd_order

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
MAX_NEW = 8
MPN = 16
BUCKET = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny worlds: one intra-op thread keeps this file off the other test
    workers' cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mods(pkg: str):
    return (importlib.import_module(f"{pkg}.models.api"),
            importlib.import_module(f"{pkg}.utils.testing"))


def build_world(pkg: str, seed: int = 0, n_zones: int = 3,
                n_nodes: int = 18):
    """(nodes, pods, templates) with `pkg`'s own objects: every dense
    constraint kind, one pending group each (unique labels, so no group's
    selector reaches another pending group)."""
    api, t = _mods(pkg)
    rng = np.random.RandomState(seed)
    zones = [f"z{k}" for k in range(n_zones)]
    nodes = []
    for i in range(n_nodes):
        nodes.append(t.build_test_node(
            f"n{i}", cpu_milli=int(rng.choice([2000, 4000, 8000])),
            mem_mib=8192, pods=110, labels={"pool": "a" if i % 2 else "b"},
            zone="" if i % 7 == 6 else zones[i % n_zones]))
    pods = []

    def res(name, node, app, **kw):
        p = t.build_test_pod(name, cpu_milli=int(rng.choice([100, 300])),
                             mem_mib=128, node_name=node, labels={"app": app},
                             owner_name=kw.pop("owner", f"rs-{app}"))
        p.phase = "Running"
        for k, v in kw.items():
            setattr(p, k, v)
        return p

    for i, nd in enumerate(nodes):
        if i % 3 == 0:
            pods.append(res(f"db{i}", nd.name, "db"))
            if i % 9 == 0:
                # not evictable: its node cannot drain
                pods[-1].annotations[api.SAFE_TO_EVICT_KEY] = "false"
        if i % 4 == 1:
            pods.append(res(f"cache{i}", nd.name, "cache"))
        if i % 5 == 2:
            pods.append(res(f"web{i}", nd.name, "web"))
        if i % 6 == 4:
            # constrained residents: the drain re-places them through the
            # wave placer
            pods.append(res(
                f"sp{i}", nd.name, "sp", topology_spread=[
                    api.TopologySpreadConstraint(
                        max_skew=1, topology_key=ZONE,
                        match_labels={"app": "sp"})]))
            pods.append(res(
                f"ah{i}", nd.name, "ah", anti_affinity=[api.AffinityTerm(
                    match_labels={"app": "ah"}, topology_key=HOST)]))
        if i < n_zones:
            # one per zone, with zone anti-affinity to each other: each
            # re-places only inside its own zone (its candidate leaves the
            # zone's count) or onto a node without a zone
            pods.append(res(
                f"az{i}", nd.name, "az", anti_affinity=[api.AffinityTerm(
                    match_labels={"app": "az"}, topology_key=ZONE)]))
    spread = api.TopologySpreadConstraint
    term = api.AffinityTerm
    kinds = [
        ("zone-spread-1", dict(topology_spread=[spread(
            max_skew=1, topology_key=ZONE, match_labels={"app": "g0"})])),
        ("zone-spread-2", dict(topology_spread=[spread(
            max_skew=2, topology_key=ZONE, match_labels={"app": "g1"})])),
        ("host-spread-1", dict(topology_spread=[spread(
            max_skew=1, topology_key=HOST, match_labels={"app": "g2"})])),
        ("host-spread-2-residents", dict(topology_spread=[spread(
            max_skew=2, topology_key=HOST, match_labels={"app": "db"})])),
        ("zone-spread-1-residents", dict(topology_spread=[spread(
            max_skew=1, topology_key=ZONE, match_labels={"app": "cache"})])),
        ("host-affinity-residents", dict(pod_affinity=[term(
            match_labels={"app": "db"}, topology_key=HOST)])),
        ("zone-affinity-residents", dict(pod_affinity=[term(
            match_labels={"app": "cache"}, topology_key=ZONE)])),
        ("host-affinity-self", dict(pod_affinity=[term(
            match_labels={"app": "g7"}, topology_key=HOST)])),
        ("zone-affinity-self", dict(pod_affinity=[term(
            match_labels={"app": "g8"}, topology_key=ZONE)])),
        ("host-anti-self", dict(anti_affinity=[term(
            match_labels={"app": "g9"}, topology_key=HOST)])),
        ("zone-anti-self", dict(anti_affinity=[term(
            match_labels={"app": "g10"}, topology_key=ZONE)])),
        ("host-anti-residents", dict(anti_affinity=[term(
            match_labels={"app": "db"}, topology_key=HOST)])),
        ("zone-anti-residents", dict(anti_affinity=[term(
            match_labels={"app": "web"}, topology_key=ZONE)])),
        ("unconstrained", {}),
    ]
    for g, (_, extra) in enumerate(kinds):
        cpu = int(rng.choice([250, 500, 1000]))
        for i in range(int(rng.randint(3, 9))):
            p = t.build_test_pod(f"p{g}-{i}", cpu_milli=cpu, mem_mib=256,
                                 owner_name=f"prs{g}", labels={"app": f"g{g}"})
            for k, v in extra.items():
                setattr(p, k, list(v))
            pods.append(p)
    # one zone eligible, maxSkew 1: one pod a wave, so 140 pods run into
    # MAX_WAVES (128 placed, the rest dropped, as in the reference)
    for i in range(140):
        p = t.build_test_pod(f"w{i}", cpu_milli=1, mem_mib=1,
                             owner_name="wave-rs", labels={"app": "wave"},
                             node_selector={ZONE: zones[0]})
        p.topology_spread = [spread(max_skew=1, topology_key=ZONE,
                                    match_labels={"app": "wave"})]
        pods.append(p)
    templates = []
    for k in range(4):
        tmpl = t.build_test_node(
            f"tmpl{k}", cpu_milli=[2000, 4000, 8000, 16000][k], mem_mib=16384,
            pods=64, labels={"pool": "a" if k % 2 else "b"},
            zone=zones[k % n_zones] if k < 3 else "")
        templates.append((tmpl, 6, float(1 + k)))
    return nodes, pods, templates


def encode(pkg: str, world):
    enc_mod = importlib.import_module(f"{pkg}.models.encode")
    rules = importlib.import_module(f"{pkg}.simulator.drainability.rules")
    nodes, pods, templates = world
    kw = {} if pkg == REF else {"device": "cpu"}
    enc = enc_mod.encode_cluster(nodes, pods, node_bucket=BUCKET,
                                 group_bucket=BUCKET, **kw)
    rules.apply_drainability(enc, now=0.0)
    groups = enc_mod.encode_node_groups(templates, enc.registry,
                                        enc.zone_table, **kw)
    return enc, groups


_CACHE: dict = {}


def both(seed: int = 0, n_zones: int = 3):
    """Both packages' encodings of one world (cached per module)."""
    key = (seed, n_zones)
    if key not in _CACHE:
        _CACHE[key] = (encode(REF, build_world(REF, seed, n_zones)),
                       encode(PORT, build_world(PORT, seed, n_zones)))
    return _CACHE[key]


def _ref_cons_inputs(enc):
    z = enc.dims.max_zones
    mask = ref_preds.feasibility_mask(enc.nodes, enc.specs,
                                      check_resources=False)
    mask = mask & ref_con.planes_static_mask(enc.specs, enc.planes,
                                             enc.nodes.zone_id, z)
    cons = ref_con.constraints_for_nodes(enc.specs, enc.planes, enc.nodes, z)
    order = ref_ffd_order(enc.specs.req,
                          enc.specs.valid & (enc.specs.count > 0))
    count = jnp.where(enc.specs.valid, enc.specs.count, 0)
    return mask, cons, order, count


def _port_cons_inputs(enc):
    z = enc.dims.max_zones
    mask = predicates.feasibility_mask(enc.nodes, enc.specs,
                                       check_resources=False)
    mask = mask & constrained.planes_static_mask(enc.specs, enc.planes,
                                                 enc.nodes.zone_id, z)
    cons = constrained.constraints_for_nodes(enc.specs, enc.planes,
                                             enc.nodes, z)
    order = ffd_order(enc.specs.req, enc.specs.valid & (enc.specs.count > 0))
    count = torch.where(enc.specs.valid, enc.specs.count, 0)
    return mask, cons, order, count


# ------------------------------------------------------------- the world


def test_world_carries_every_constraint_kind():
    (ref_enc, _), (enc, _) = both()
    assert enc.has_constraints and ref_enc.has_constraints
    s = enc.specs
    live = (s.count > 0) & ~s.needs_host_check
    assert bool(((s.spread_kind == 2) & s.spread_self & live).any())
    assert bool(((s.spread_kind == 1) & s.spread_self & live).any())
    assert bool(((s.spread_kind > 0) & ~s.spread_self & live).any())
    assert bool(((s.max_skew == 2) & live).any())
    for kind in (1, 2):
        assert bool(((s.aff_kind == kind) & s.aff_self & live).any())
        assert bool(((s.aff_kind == kind) & ~s.aff_self & live).any())
    assert bool((s.anti_affinity_self & live).any())
    assert bool((s.anti_self_zone & live).any())
    assert int(enc.planes.anti_host_cnt.sum()) > 0
    assert int(enc.planes.anti_zone_cnt.sum()) > 0
    assert bool((enc.nodes.valid & (enc.nodes.zone_id == 0)).any())
    # constrained residents for the drain
    grp = enc.scheduled.group_ref[enc.scheduled.valid].long()
    assert bool((s.spread_kind[grp] > 0).any())
    # the lossy world: more zones than the dims hold
    (_, _), (lossy, _) = both(seed=1, n_zones=20)
    assert bool((lossy.specs.needs_host_check & (lossy.specs.count > 0)).any())
    assert int(lossy.specs.spread_kind.max()) < 2


# ------------------------------------------------------- ops/constrained


@pytest.mark.parametrize("world", [dict(), dict(seed=1, n_zones=20)],
                         ids=["zones", "too-many-zones"])
def test_constraint_planes_match_reference(world):
    (ref_enc, _), (enc, _) = both(**world)
    z = enc.dims.max_zones
    assert_trees_equal(
        (ref_con.zone_onehot(ref_enc.nodes.zone_id, z),
         ref_con.zone_agg(ref_enc.planes.spread_cnt, ref_enc.nodes.zone_id, z),
         ref_con.zone_agg(ref_enc.planes.aff_cnt, ref_enc.nodes.zone_id, 4),
         ref_con.planes_static_mask(ref_enc.specs, ref_enc.planes,
                                    ref_enc.nodes.zone_id, z)),
        (constrained.zone_onehot(enc.nodes.zone_id, z),
         constrained.zone_agg(enc.planes.spread_cnt, enc.nodes.zone_id, z),
         constrained.zone_agg(enc.planes.aff_cnt, enc.nodes.zone_id, 4),
         constrained.planes_static_mask(enc.specs, enc.planes,
                                        enc.nodes.zone_id, z)))
    ref_c = ref_con.constraints_for_nodes(ref_enc.specs, ref_enc.planes,
                                          ref_enc.nodes, z)
    got_c = constrained.constraints_for_nodes(enc.specs, enc.planes,
                                              enc.nodes, z)
    assert_trees_equal(ref_c, got_c)
    assert_trees_equal(ref_c.is_constrained(), got_c.is_constrained())


def test_place_group_constrained_matches_reference():
    """Every constrained group of the world alone on the free capacity,
    through both packages' single-group wave placer."""
    (ref_enc, _), (enc, _) = both()
    rmask, rcons, _, rcount = _ref_cons_inputs(ref_enc)
    mask, cons, _, count = _port_cons_inputs(enc)
    z = enc.dims.max_zones
    con = np.asarray(rcons.is_constrained()) & (np.asarray(rcount) > 0)
    assert con.sum() >= 10
    limit = enc.specs.one_per_node()
    rlimit = ref_enc.specs.one_per_node()
    for g in np.flatnonzero(con).tolist():
        ref = ref_con.place_group_constrained(
            ref_enc.nodes.free(), rmask[g], ref_enc.specs.req[g], rcount[g],
            rlimit[g], type(rcons)(**{
                k: (v if k in ("zone_cl", "zone_valid") else v[g])
                for k, v in vars(rcons).items()}), z)
        got = constrained.place_group_constrained(
            enc.nodes.free(), mask[g], enc.specs.req[g], count[g], limit[g],
            type(cons)(**{k: (v if k in ("zone_cl", "zone_valid") else v[g])
                          for k, v in vars(cons).items()}), z)
        assert_trees_equal(ref, got)


def test_pack_groups_constrained_matches_reference():
    (ref_enc, _), (enc, _) = both()
    z = enc.dims.max_zones
    rmask, rcons, rorder, rcount = _ref_cons_inputs(ref_enc)
    mask, cons, order, count = _port_cons_inputs(enc)
    ref = ref_con.pack_groups_constrained(
        ref_enc.nodes.free(), rmask, ref_enc.specs.req, rcount, rorder,
        ref_enc.specs.one_per_node(), rcons, z)
    got = constrained.pack_groups_constrained(
        enc.nodes.free(), mask, enc.specs.req, count, order,
        enc.specs.one_per_node(), cons, z)
    assert_trees_equal(ref, got)
    sched = leaves(ref)[".scheduled"]
    assert sched.sum() > 0
    # the wave group ran into the cap: 128 of its 140 pods placed
    assert 128 in sched.tolist()


@pytest.mark.parametrize("check", [1, 8])
def test_wave_check_interval_changes_no_output(check, monkeypatch):
    """The flag read's interval only adds no-op waves: the pack, the
    estimate and the drain sweep are equal at every interval."""
    (_, _), (enc, groups) = both()

    def run():
        return autoscale_step.run_once_fused(
            enc.nodes, enc.specs, enc.scheduled, groups,
            torch.full((groups.ng,), MAX_NEW, dtype=torch.int32), enc.dims,
            max_new_nodes=MAX_NEW, max_pods_per_node=MPN, planes=enc.planes,
            with_constraints=True)

    default = run()
    waves = constrained.place_lanes.waves
    monkeypatch.setattr(constrained, "WAVE_CHECK", check)
    assert_trees_equal(default, run())
    assert constrained.place_lanes.waves > waves


# ------------------------------------------------- the constrained branches


def test_schedule_pending_on_existing_matches_reference():
    (ref_enc, _), (enc, _) = both()
    ref = ref_schedule.schedule_pending_on_existing(
        ref_enc.nodes, ref_enc.specs, ref_enc.scheduled, planes=ref_enc.planes,
        max_zones=ref_enc.dims.max_zones, with_constraints=True)
    got = schedule.schedule_pending_on_existing(
        enc.nodes, enc.specs, enc.scheduled, planes=enc.planes,
        max_zones=enc.dims.max_zones, with_constraints=True)
    assert_trees_equal(ref, got)


def test_estimate_all_matches_reference():
    (ref_enc, ref_groups), (enc, groups) = both()
    ref = ref_binpack.estimate_all(
        ref_enc.specs, ref_groups, ref_enc.dims, MAX_NEW,
        planes=ref_enc.planes, nodes=ref_enc.nodes, with_constraints=True)
    got = binpack.estimate_all(
        enc.specs, groups, enc.dims, MAX_NEW, planes=enc.planes,
        nodes=enc.nodes, with_constraints=True)
    assert_trees_equal(ref, got)
    assert leaves(ref)[".node_count"].sum() > 0


@pytest.mark.parametrize("chunk", [5, None], ids=["chunk-5", "default-chunk"])
def test_simulate_removals_matches_reference(chunk):
    (ref_enc, _), (enc, _) = both()
    n = enc.nodes.n
    ref = ref_drain.simulate_removals(
        ref_enc.nodes, ref_enc.specs, ref_enc.scheduled,
        jnp.arange(n, dtype=jnp.int32), jnp.ones((n,), bool),
        max_pods_per_node=MPN, chunk=8, planes=ref_enc.planes,
        max_zones=ref_enc.dims.max_zones, with_constraints=True)
    reads = constrained.place_lanes.flag_reads
    got = drain.simulate_removals(
        enc.nodes, enc.specs, enc.scheduled,
        torch.arange(n, dtype=torch.int32), torch.ones((n,), dtype=torch.bool),
        max_pods_per_node=MPN, chunk=chunk, planes=enc.planes,
        max_zones=enc.dims.max_zones, with_constraints=True)
    assert_trees_equal(ref, got)
    dec = leaves(ref)
    assert dec[".drainable"].any() and dec[".has_blocker"].any()
    assert constrained.place_lanes.flag_reads > reads   # the slow lanes ran


# ----------------------------------------------------------- the steps


@pytest.mark.parametrize("world", [dict(), dict(seed=1, n_zones=20)],
                         ids=["zones", "too-many-zones"])
def test_run_once_fused_matches_reference(world):
    (ref_enc, ref_groups), (enc, groups) = both(**world)
    cap = np.full((groups.ng,), MAX_NEW, np.int32)
    cap[1] = 2
    ref = ref_step.run_once_fused(
        ref_enc.nodes, ref_enc.specs, ref_enc.scheduled, ref_groups,
        jnp.asarray(cap), ref_enc.dims, max_new_nodes=MAX_NEW,
        max_pods_per_node=MPN, chunk=8, planes=ref_enc.planes,
        with_constraints=True)
    got = autoscale_step.run_once_fused(
        enc.nodes, enc.specs, enc.scheduled, groups, torch.from_numpy(cap),
        enc.dims, max_new_nodes=MAX_NEW, max_pods_per_node=MPN,
        planes=enc.planes, with_constraints=True)
    assert_trees_equal(ref, got, float_rtol=1e-6)
    dec = leaves(ref[0])
    assert dec[".verdict"].sum() > 0 and dec[".est_node_count"].sum() > 0


def test_phased_steps_match_reference():
    (ref_enc, ref_groups), (enc, groups) = both()
    ref_up = ref_step.scale_up_sim(
        ref_enc.nodes, ref_enc.specs, ref_enc.scheduled, ref_groups,
        ref_enc.dims, MAX_NEW, "least-waste", ref_enc.planes, True)
    got_up = autoscale_step.scale_up_sim(
        enc.nodes, enc.specs, enc.scheduled, groups, enc.dims, MAX_NEW,
        "least-waste", planes=enc.planes, with_constraints=True)
    assert_trees_equal(ref_up, got_up, float_rtol=1e-6)
    ref_down = ref_step.scale_down_sim(
        ref_enc.nodes, ref_enc.specs, ref_enc.scheduled, 0.5, MPN, 8,
        ref_enc.planes, ref_enc.dims.max_zones, True)
    got_down = autoscale_step.scale_down_sim(
        enc.nodes, enc.specs, enc.scheduled, 0.5, MPN, planes=enc.planes,
        max_zones=enc.dims.max_zones, with_constraints=True)
    assert_trees_equal(ref_down, got_down, float_rtol=1e-6)
    ref_once = ref_step.run_once_sim(
        RefClusterTensors(nodes=ref_enc.nodes, pending=ref_enc.specs,
                          scheduled=ref_enc.scheduled, groups=ref_groups,
                          planes=ref_enc.planes),
        ref_enc.dims, max_new_nodes=MAX_NEW, max_pods_per_node=MPN,
        with_constraints=True)
    got_once = autoscale_step.run_once_sim(
        ClusterTensors(nodes=enc.nodes, pending=enc.specs,
                       scheduled=enc.scheduled, groups=groups,
                       planes=enc.planes),
        enc.dims, max_new_nodes=MAX_NEW, max_pods_per_node=MPN,
        with_constraints=True)
    assert_trees_equal(ref_once, got_once, float_rtol=1e-6)
    # the constraints change the answer: the unconstrained step differs
    plain = autoscale_step.scale_up_sim(
        enc.nodes, enc.specs, enc.scheduled, groups, enc.dims, MAX_NEW)
    assert not torch.equal(plain.fits_existing, got_up.fits_existing)


# ------------------------------------------- oracle properties (port only)


def _pack(nodes, pods, max_zones=16):
    from kubernetes_autoscaler_tpu_torch.models.encode import encode_cluster

    enc = encode_cluster(nodes, pods, device="cpu")
    mask, cons, order, count = _port_cons_inputs(enc)
    res = constrained.pack_groups_constrained(
        enc.nodes.free(), mask, enc.specs.req, count, order,
        enc.specs.one_per_node(), cons, max_zones)
    return enc, res.placed.numpy(), order.numpy()


def _serial_greedy(enc, nodes, order):
    """One-pod-at-a-time first-fit greedy asking the port's oracle for
    every placement, in the pack's group order."""
    from kubernetes_autoscaler_tpu_torch.utils import oracle

    by_node = {}
    for p in enc.scheduled_pods:
        by_node.setdefault(p.node_name, []).append(p)
    placed = np.zeros((enc.specs.g, len(nodes)), dtype=np.int64)
    for g in order:
        if g >= len(enc.group_pods) or not enc.group_pods[g]:
            continue
        for pi in enc.group_pods[g]:
            pod = enc.pending_pods[pi]
            for ni, nd in enumerate(nodes):
                if oracle.check_pod_in_cluster(pod, nd, nodes, by_node):
                    clone = copy.deepcopy(pod)
                    clone.node_name = nd.name
                    clone.phase = "Running"
                    by_node.setdefault(nd.name, []).append(clone)
                    placed[g, ni] += 1
                    break
    return placed


def _check_match(nodes, pods):
    enc, placed, order = _pack(nodes, pods)
    want = _serial_greedy(enc, nodes, order)
    got = placed[:, : len(nodes)]
    np.testing.assert_array_equal(
        got[: want.shape[0]], want,
        err_msg=f"pack={got[:want.shape[0]].tolist()} oracle={want.tolist()}")


def _oracle_case(name):
    """The reference's fixed oracle cases, built with the port's objects."""
    from kubernetes_autoscaler_tpu_torch.models.api import (
        AffinityTerm,
        TopologySpreadConstraint,
    )
    from kubernetes_autoscaler_tpu_torch.utils.testing import (
        build_test_node,
        build_test_pod,
    )

    def resident(name, app, node):
        p = build_test_pod(name, cpu_milli=10, mem_mib=10,
                           labels={"app": app}, node_name=node)
        p.phase = "Running"
        return p

    def group(prefix, n, app, cpu=10, **extra):
        out = []
        for i in range(n):
            p = build_test_pod(f"{prefix}{i}", cpu_milli=cpu, mem_mib=10,
                               labels={"app": app}, owner_name=f"{app}-rs")
            for k, v in extra.items():
                setattr(p, k, list(v))
            out.append(p)
        return out

    def zoned(zs):
        return [build_test_node(f"n{i}", cpu_milli=4000, mem_mib=8192, zone=z)
                for i, z in enumerate(zs)]

    if name == "spread-zone":
        spread = [TopologySpreadConstraint(max_skew=1, topology_key=ZONE,
                                           match_labels={"app": "w"})]
        return zoned("aabc"), [resident("r0", "w", "n0")] + group(
            "p", 6, "w", topology_spread=spread)
    if name == "spread-hostname":
        nodes = [build_test_node(f"n{i}", cpu_milli=4000, mem_mib=8192)
                 for i in range(4)]
        spread = [TopologySpreadConstraint(max_skew=2, topology_key=HOST,
                                           match_labels={"app": "h"})]
        return nodes, group("p", 7, "h", topology_spread=spread)
    if name == "affinity-zone":
        aff = [AffinityTerm(match_labels={"app": "db"}, topology_key=ZONE)]
        return zoned("abb"), [resident("db", "db", "n1")] + group(
            "w", 3, "w", pod_affinity=aff)
    if name == "self-affinity-gang":
        nodes = [build_test_node(f"n{i}", cpu_milli=1000, mem_mib=8192,
                                 pods=100) for i in range(3)]
        aff = [AffinityTerm(match_labels={"app": "gang"}, topology_key=HOST)]
        return nodes, group("g", 4, "gang", cpu=300, pod_affinity=aff)
    if name == "anti-zone-self":
        anti = [AffinityTerm(match_labels={"app": "za"}, topology_key=ZONE)]
        return zoned("aab"), group("a", 3, "za", anti_affinity=anti)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["spread-zone", "spread-hostname",
                                  "affinity-zone", "self-affinity-gang",
                                  "anti-zone-self"])
def test_constrained_pack_matches_oracle(name):
    _check_match(*_oracle_case(name))


def test_unconstrained_groups_identical_to_fast_path():
    from kubernetes_autoscaler_tpu_torch.models.encode import encode_cluster
    from kubernetes_autoscaler_tpu_torch.ops.pack import pack_groups
    from kubernetes_autoscaler_tpu_torch.utils.testing import (
        build_test_node,
        build_test_pod,
    )

    nodes = [build_test_node(f"n{i}", cpu_milli=2000, mem_mib=4096, zone="a")
             for i in range(5)]
    pods = [build_test_pod(f"p{i}", cpu_milli=700, mem_mib=512,
                           owner_name="rs") for i in range(9)]
    enc = encode_cluster(nodes, pods, device="cpu")
    maskp, cons, order, count = _port_cons_inputs(enc)
    mask = predicates.feasibility_mask(enc.nodes, enc.specs,
                                       check_resources=False)
    a = constrained.pack_groups_constrained(
        enc.nodes.free(), maskp, enc.specs.req, count, order,
        enc.specs.one_per_node(), cons, 16)
    b = pack_groups(enc.nodes.free(), mask, enc.specs.req, count, order,
                    enc.specs.one_per_node())
    assert torch.equal(a.placed, b.placed)


def _random_world(rng, mixed: bool):
    from kubernetes_autoscaler_tpu_torch.models.api import (
        AffinityTerm,
        TopologySpreadConstraint,
    )
    from kubernetes_autoscaler_tpu_torch.utils.testing import (
        build_test_node,
        build_test_pod,
    )

    zones = ["a", "b", "c"][: rng.randint(2 if mixed else 1, 3)]
    n_lo = 3 if mixed else 2
    cpus = [1000, 2000] if mixed else [500, 1000, 2000]
    nodes = [build_test_node(f"n{i}", cpu_milli=rng.choice(cpus),
                             mem_mib=4096, zone=rng.choice(zones))
             for i in range(rng.randint(n_lo, 6))]
    pods = []
    for i in range(rng.randint(0, 3 if mixed else 4)):
        q = build_test_pod(f"r{i}", cpu_milli=100, mem_mib=32,
                           labels={"app": "db" if mixed
                                   else rng.choice(["w", "db"])},
                           node_name=rng.choice(nodes).name)
        q.phase = "Running"
        pods.append(q)
    if mixed:
        # spread AND affinity/anti on the SAME pod
        for i in range(rng.randint(2, 5)):
            p = build_test_pod(f"m{i}", cpu_milli=100, mem_mib=32,
                               labels={"app": "m"}, owner_name="m-rs")
            p.topology_spread = [TopologySpreadConstraint(
                max_skew=1, topology_key=ZONE, match_labels={"app": "m"})]
            if rng.random() < 0.5:
                p.pod_affinity = [AffinityTerm(match_labels={"app": "db"},
                                               topology_key=ZONE)]
            else:
                p.anti_affinity = [AffinityTerm(match_labels={"app": "db"},
                                                topology_key=ZONE)]
            pods.append(p)
        return nodes, pods
    for gi in range(rng.randint(1, 3)):
        kind = rng.choice(["spread", "aff", "anti"])
        app = rng.choice(["w", "db"])
        sel = {"app": app, "grp": str(gi)}
        for i in range(rng.randint(1, 5)):
            p = build_test_pod(f"g{gi}p{i}", cpu_milli=100, mem_mib=32,
                               labels=dict(sel), owner_name=f"rs-{gi}")
            if kind == "spread":
                p.topology_spread = [TopologySpreadConstraint(
                    max_skew=rng.randint(1, 2), topology_key=ZONE,
                    match_labels=dict(sel))]
            elif kind == "aff":
                p.pod_affinity = [AffinityTerm(
                    match_labels=dict(sel),
                    topology_key=rng.choice([ZONE, HOST]))]
            else:
                p.anti_affinity = [AffinityTerm(
                    match_labels=dict(sel),
                    topology_key=rng.choice([ZONE, HOST]))]
            pods.append(p)
    return nodes, pods


@pytest.mark.parametrize("mixed, seed, trials", [(False, 7, 6), (True, 42, 5)],
                         ids=["kinds", "mixed"])
def test_randomized_topology_pack_matches_oracle(mixed, seed, trials):
    rng = random.Random(seed)
    checked = 0
    for trial in range(trials):
        nodes, pods = _random_world(rng, mixed)
        enc, placed, order = _pack(nodes, pods)
        flagged = enc.specs.needs_host_check.numpy()
        if flagged[enc.specs.count.numpy() > 0].any():
            continue  # cross-group coupling -> host-check tier, not the pack
        want = _serial_greedy(enc, nodes, order)
        np.testing.assert_array_equal(
            placed[:, : len(nodes)][: want.shape[0]], want,
            err_msg=f"trial {trial}")
        checked += 1
    assert checked > 0

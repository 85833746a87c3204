"""The port's what-if multiverse (`kubernetes_autoscaler_tpu_torch.whatif`)
against the JAX package's, on the CPU.

Each package builds its own synthetic branch world from the same seed
(`synthetic_branch`: 8 nodes, 6 pending pods, one live fused loop; the
"scale-up" world's pending pods of 3,500m need new nodes) and the same
variants. Compared: the workload generator, the lane-stacked inputs,
a multiverse step (every decision and summary leaf: ints and bools by
bytes, f32 within rtol 1e-6; the lane digests equal), a multiverse rollout
(trajectory digests equal) and the command line's report. Pinned on the
port alone: lane 0 equals a serial `run_once_fused` under churn, rollout
lane b equals `rollout_fused`, the null-lane rollout equals T live loops on
a world in equilibrium, a journal cursor branches to the live branch's
digests, a branch is unchanged by the loops after it, and the entry points
raise without CUDA unless given a device.

One lane rung (B = 4) and one rollout length (T = 4) throughout, and
module-scoped worlds, so the JAX side compiles its programs once.
"""

from __future__ import annotations

import importlib
import json

import numpy as np
import pytest
import torch

from torch_parity import PORT, REF, assert_trees_equal

PKG = {"jax": REF, "torch": PORT}
WORLDS = {"fits": {}, "scale-up": {"pending_milli": 3500}}
B = 4
T_STEPS = 4


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{PKG[pkg]}.{name}")


def _variants(pkg: str) -> list:
    V = _mod(pkg, "whatif.variants").VariantSpec
    return [V(name="half-price", price_scale=0.5),
            V(name="tight-cap", max_new_cap=1),
            V(name="hot-drain", threshold=0.9),
            V(name="reclaim", fail_nodes=(1,))]


def _kw(pkg: str, lanes) -> dict:
    st = lanes.statics
    kw = dict(dims=st["dims"], max_new_nodes=st["max_new_nodes"],
              max_pods_per_node=st["max_pods_per_node"])
    if pkg == "jax":
        kw["chunk"] = st["chunk"]
    return kw


def _step(pkg: str, lanes):
    return _mod(pkg, "whatif.kernel").multiverse_step(
        lanes.nodes, lanes.specs, lanes.scheduled, lanes.groups,
        lanes.limit_cap, **_kw(pkg, lanes))


def _dev(pkg: str) -> dict:
    return {"device": "cpu"} if pkg == "torch" else {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The worlds here are tiny: one intra-op thread is enough, and keeps
    this file from crowding the other test workers' cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def all_worlds():
    """{(pkg, world): branch} of the synthetic worlds, seed 5."""
    return {(pkg, kind): _mod(pkg, "whatif.synthetic").synthetic_branch(
                seed=5, **kw, **_dev(pkg))[0]
            for kind, kw in WORLDS.items() for pkg in PKG}


@pytest.fixture(scope="module")
def worlds(all_worlds):
    """{pkg: branch} of the default world."""
    return {pkg: all_worlds[(pkg, "fits")] for pkg in PKG}


@pytest.fixture(scope="module")
def all_steps(all_worlds):
    """{(pkg, world): (lanes, decision, summary)}: three variants padded
    to B."""
    out = {}
    for key, branch in all_worlds.items():
        lanes = _mod(key[0], "whatif.variants").build_lanes(
            branch, _variants(key[0])[:3], pad_to=B)
        dec, summary = _step(key[0], lanes)
        out[key] = (lanes, dec, summary)
    return out


# ---- generator ---------------------------------------------------------


@pytest.mark.parametrize("kind", ["quiet", "diurnal", "bursty", "spot"])
def test_generator_matches_jax(kind):
    """Each kind's trace, and its fan-out to lanes, byte for byte."""
    out = {}
    for pkg in PKG:
        gen = _mod(pkg, "whatif.generator")
        V = _mod(pkg, "whatif.variants").VariantSpec
        spec = gen.WorkloadSpec(kind=kind, seed=42, base_rate=3.0,
                                burst_prob=0.5, burst_size=7,
                                reclaim_prob=0.5, reclaim_nodes=2)
        assert gen.WorkloadSpec.from_record(spec.to_record()) == spec
        adds, fails = gen.generate_workload(spec, 16, 8, 12)
        ab, fb = gen.lane_workloads(
            [V(name="null"), V(name="surge", pending_scale=2.0)], adds, fails)
        out[pkg] = (adds, fails, ab, fb)
    for ref, got in zip(out["jax"], out["torch"]):
        assert ref.dtype == got.dtype and ref.shape == got.shape
        assert ref.tobytes() == got.tobytes()


# ---- lanes -------------------------------------------------------------


def test_build_lanes_matches_jax(worlds):
    """Every lane-stacked leaf of the four variants padded to 8 lanes is
    the JAX package's, and lane 0 carries the branch's bytes."""
    lanes = {pkg: _mod(pkg, "whatif.variants").build_lanes(
                 worlds[pkg], _variants(pkg), pad_to=8)
             for pkg in PKG}
    ref, got = lanes["jax"], lanes["torch"]
    assert got.real == ref.real == 5 and len(got.variants) == 8
    assert [v.to_dict() for v in got.variants] \
        == [v.to_dict() for v in ref.variants]
    for name in ("nodes", "specs", "scheduled", "groups", "limit_cap",
                 "thresholds"):
        assert_trees_equal(getattr(ref, name), getattr(got, name))
    br = worlds["torch"]
    assert got.limit_cap[0].numpy().tobytes() == br.limit_cap.tobytes()
    assert got.nodes.ready[0].numpy().tobytes() \
        == br.nodes.ready.numpy().tobytes()
    assert not bool(got.nodes.ready[4, 1])
    # each lane has storage of its own: no lane is a view of the branch
    assert got.specs.count.data_ptr() != br.specs.count.data_ptr()
    assert got.nodes.cap.stride(0) == br.nodes.cap.numel()


# ---- the multiverse step -----------------------------------------------


@pytest.mark.parametrize("world", list(WORLDS))
def test_multiverse_step_matches_jax(all_steps, world):
    steps = {pkg: all_steps[(pkg, world)] for pkg in PKG}
    (_lr, dec_r, sum_r), (lanes, dec_p, sum_p) = steps["jax"], steps["torch"]
    assert_trees_equal(dec_r, dec_p, float_rtol=1e-6)
    assert_trees_equal(sum_r, sum_p, float_rtol=1e-6)
    assert (np.asarray(sum_r.best) == sum_p.best).all()
    digests = {pkg: _mod(pkg, "whatif.report").lane_digests(
                   steps[pkg][1], steps[pkg][0].real) for pkg in PKG}
    assert digests["torch"] == digests["jax"]
    # the report's numbers agree too, and lane 0's deltas are zero
    reps = {pkg: _mod(pkg, "whatif.report").build_report(
                steps[pkg][0], summary=steps[pkg][2], decision=steps[pkg][1])
            for pkg in PKG}
    for r_row, p_row in zip(reps["jax"]["summary"], reps["torch"]["summary"]):
        for k, v in r_row.items():
            if k != "deltas":
                assert p_row[k] == pytest.approx(v, rel=1e-6)
    assert all(v == 0 for v in reps["torch"]["summary"][0]["deltas"].values())
    if world == "scale-up":
        # the lanes moved their knobs: half the price, a cap of one node
        assert (sum_p.best >= 0).all()
        assert sum_p.scaleup_cost[1] == pytest.approx(
            0.5 * sum_p.scaleup_cost[0])
        assert sum_p.nodes_added[2] == 1 < sum_p.nodes_added[0]


def test_multiverse_step_is_one_round_trip(worlds):
    hf = _mod("torch", "ops.hostfetch")
    lanes = _mod("torch", "whatif.variants").build_lanes(
        worlds["torch"], _variants("torch")[:3], pad_to=B)
    hf.reset_round_trips()
    dec, summary = _step("torch", lanes)
    assert hf.round_trips() == 1
    assert isinstance(dec.verdict, np.ndarray) and dec.verdict.shape[0] == B
    assert summary.best.dtype == np.int32 and summary.best.shape == (B,)


def test_null_lane_bit_identical_to_serial_fused_under_churn():
    """Lane 0's decision surface equals a serial `run_once_fused` on the
    branch planes after a churny live sequence."""
    from kubernetes_autoscaler_tpu_torch.ops.autoscale_step import (
        run_once_fused,
    )
    from kubernetes_autoscaler_tpu_torch.utils.testing import build_test_pod
    from kubernetes_autoscaler_tpu_torch.whatif import report as wreport
    from kubernetes_autoscaler_tpu_torch.whatif.synthetic import (
        synthetic_autoscaler,
    )
    from kubernetes_autoscaler_tpu_torch.whatif.variants import (
        branch_from_live,
        build_lanes,
    )

    fake, a = synthetic_autoscaler(n_nodes=6, n_pending=5, seed=11,
                                   device="cpu")
    for loop in range(4):
        if loop == 1:
            fake.add_pod(build_test_pod("late", cpu_milli=700, mem_mib=256,
                                        owner_name="prs"))
        if loop == 2:
            fake.remove_pod("p0")
            fake.add_pod(build_test_pod("burst", cpu_milli=3900,
                                        mem_mib=512, owner_name="bg"))
        st = a.run_once(now=1000.0 + 10 * loop)
        assert st.fused_mode == "fused"
    branch = branch_from_live(a)
    lanes = build_lanes(branch, _variants("torch")[:3], pad_to=B)
    dec, _summary = _step("torch", lanes)
    serial, _res = run_once_fused(
        branch.nodes, branch.specs, branch.scheduled, branch.groups,
        torch.from_numpy(branch.limit_cap), **_kw("torch", branch))
    want = wreport._digest(*(x.numpy() for x in (
        serial.verdict, serial.pending_after, serial.est_node_count,
        serial.drainable, serial.util)))
    assert wreport.lane_digests(dec, lanes.real)[0] == want
    # and the live loop's own fetched decision is lane 0's
    assert dec.verdict[0].tobytes() \
        == a._fused_ctx["decision"].verdict.tobytes()


# ---- rollouts ----------------------------------------------------------


def _rollout(pkg: str, lanes, wl):
    gen = _mod(pkg, "whatif.generator")
    g = int(np.asarray(lanes.specs.count).shape[1])
    n = int(np.asarray(lanes.nodes.valid).shape[1])
    adds, fails = gen.generate_workload(wl, T_STEPS, g, n)
    adds_b, fails_b = gen.lane_workloads(lanes.variants, adds, fails)
    traj = _mod(pkg, "whatif.kernel").rollout_multiverse(
        lanes.nodes, lanes.specs, lanes.scheduled, lanes.groups,
        lanes.limit_cap, lanes.thresholds, adds_b, fails_b,
        **_kw(pkg, lanes))
    return traj, adds_b, fails_b


def test_rollout_multiverse_matches_jax_and_rollout_fused(worlds):
    """A bursty surge: trajectory digests equal the JAX package's; every
    leaf within the stated tolerance; the world moved; and every lane
    equals `rollout_fused` on that lane's world and workload."""
    out = {}
    for pkg in PKG:
        V = _mod(pkg, "whatif.variants").VariantSpec
        lanes = _mod(pkg, "whatif.variants").build_lanes(
            worlds[pkg], [V(name="surge", pending_scale=3.0),
                          V(name="tight-cap", max_new_cap=1),
                          V(name="hot-drain", threshold=0.9)], pad_to=B)
        wl = _mod(pkg, "whatif.generator").WorkloadSpec(
            kind="bursty", seed=2, burst_prob=1.0, burst_size=24)
        out[pkg] = (lanes, wl) + _rollout(pkg, lanes, wl)
    rep = {pkg: _mod(pkg, "whatif.report").build_report(
               out[pkg][0], traj=out[pkg][2], workload=out[pkg][1])
           for pkg in PKG}
    assert rep["torch"]["rollout"]["trajectoryDigests"] \
        == rep["jax"]["rollout"]["trajectoryDigests"]
    assert_trees_equal(out["jax"][2], out["torch"][2], float_rtol=1e-6)
    per = rep["torch"]["rollout"]["perLane"]
    assert any(row["nodesAdded"] > 0 for row in per), per
    assert len(set(rep["torch"]["rollout"]["trajectoryDigests"])) > 1

    lanes, _wl, traj, adds_b, fails_b = out["torch"]
    kernel = _mod("torch", "whatif.kernel")
    for b in range(lanes.real):
        one = kernel.rollout_fused(
            kernel._lane(lanes.nodes, b), kernel._lane(lanes.specs, b),
            kernel._lane(lanes.scheduled, b), kernel._lane(lanes.groups, b),
            lanes.limit_cap[b], lanes.thresholds[b], adds_b[b], fails_b[b],
            **_kw("torch", lanes))
        assert_trees_equal(kernel._lane(traj, b), one)


def test_rollout_is_one_round_trip(worlds):
    hf = _mod("torch", "ops.hostfetch")
    lanes = _mod("torch", "whatif.variants").build_lanes(
        worlds["torch"], [], pad_to=B)
    wl = _mod("torch", "whatif.generator").WorkloadSpec(kind="diurnal",
                                                         seed=1)
    hf.reset_round_trips()
    traj, _a, _f = _rollout("torch", lanes, wl)
    assert hf.round_trips() == 1
    assert traj.verdict.shape[:2] == (B, T_STEPS)


def test_rollout_null_lane_matches_live_trajectory():
    """On a world in equilibrium with its own decisions, lane 0's rollout
    trajectory digest equals T live fused loops of the same autoscaler."""
    from kubernetes_autoscaler_tpu_torch.whatif import report as wreport
    from kubernetes_autoscaler_tpu_torch.whatif.generator import WorkloadSpec
    from kubernetes_autoscaler_tpu_torch.whatif.synthetic import (
        synthetic_branch,
    )
    from kubernetes_autoscaler_tpu_torch.whatif.variants import build_lanes

    branch, auto = synthetic_branch(n_nodes=6, n_pending=4, seed=7,
                                    loops=2, pending_milli=64000,
                                    device="cpu")
    live_verd, live_pend = [], []
    for k in range(T_STEPS):
        st = auto.run_once(now=2000.0 + 10.0 * k)
        assert st.fused_mode == "fused"
        dec = auto._fused_ctx["decision"]
        live_verd.append(np.array(dec.verdict))
        live_pend.append(np.array(dec.pending_after))
    assert any(p.sum() > 0 for p in live_pend), "world must be nontrivial"
    lanes = build_lanes(branch, _variants("torch")[:3], pad_to=B)
    traj, _a, _f = _rollout("torch", lanes, WorkloadSpec(kind="quiet"))
    live = wreport._digest(np.stack(live_verd), np.stack(live_pend))
    assert wreport.trajectory_digests(traj, lanes.real)[0] == live


# ---- branches ----------------------------------------------------------


def test_branch_from_journal_gives_the_live_branch(tmp_path):
    """A journal cursor replayed on the port branches to the same lanes as
    the live loop at that loop; an earlier cursor is a different world."""
    from kubernetes_autoscaler_tpu_torch.utils.testing import build_test_pod
    from kubernetes_autoscaler_tpu_torch.whatif import report as wreport
    from kubernetes_autoscaler_tpu_torch.whatif.synthetic import (
        synthetic_autoscaler,
    )
    from kubernetes_autoscaler_tpu_torch.whatif.variants import (
        branch_from_journal,
        branch_from_live,
        build_lanes,
    )

    def report(branch):
        lanes = build_lanes(branch, _variants("torch")[:3], pad_to=B)
        dec, summary = _step("torch", lanes)
        return wreport.build_report(lanes, summary=summary, decision=dec)

    jdir = str(tmp_path / "journal")
    fake, a = synthetic_autoscaler(n_nodes=6, n_pending=5, seed=11,
                                   journal_dir=jdir, device="cpu")
    live = None
    for loop in range(4):
        if loop == 2:
            fake.add_pod(build_test_pod("late", cpu_milli=700, mem_mib=256,
                                        owner_name="prs"))
        a.run_once(now=1000.0 + 10 * loop)
        if loop == 2:
            live = report(branch_from_live(a))
    at2 = report(branch_from_journal(jdir, upto=2, device="cpu"))
    assert at2["laneDigests"] == live["laneDigests"]
    assert json.dumps(at2["summary"], sort_keys=True) \
        == json.dumps(live["summary"], sort_keys=True)
    at1 = report(branch_from_journal(jdir, upto=1, device="cpu"))
    assert at1["laneDigests"] != at2["laneDigests"]


def test_branch_unchanged_by_the_next_loop():
    """A branch taken at loop k holds loop k's tensors: loop k+1, with pod
    churn and a burst, changes none of their bytes or versions."""
    from kubernetes_autoscaler_tpu_torch.utils.testing import build_test_pod
    from kubernetes_autoscaler_tpu_torch.whatif.kernel import _map
    from kubernetes_autoscaler_tpu_torch.whatif.synthetic import (
        synthetic_autoscaler,
    )
    from kubernetes_autoscaler_tpu_torch.whatif.variants import (
        branch_from_live,
        build_lanes,
    )

    fake, a = synthetic_autoscaler(n_nodes=6, n_pending=5, seed=11,
                                   device="cpu")
    a.run_once(now=1000.0)
    branch = branch_from_live(a)
    lanes = build_lanes(branch, _variants("torch"), pad_to=8)
    trees = (branch.nodes, branch.specs, branch.scheduled, branch.groups,
             lanes.nodes, lanes.specs, lanes.groups)
    before = []
    for tree in trees:
        _map(lambda x: before.append((x.clone(), x._version)), tree)
    cap = branch.limit_cap.copy()

    fake.remove_pod("p0")
    fake.add_pod(build_test_pod("burst", cpu_milli=3900, mem_mib=512,
                                owner_name="bg"))
    fake.add_pod(build_test_pod("late", cpu_milli=700, mem_mib=256,
                                owner_name="prs"))
    st = a.run_once(now=1010.0)
    assert st.fused_mode == "fused"
    assert a._fused_ctx["inputs"][1] is not branch.specs
    after = []
    for tree in trees:
        _map(lambda x: after.append((x, x._version)), tree)
    assert len(after) == len(before)
    for (x0, v0), (x1, v1) in zip(before, after):
        assert v1 == v0
        assert x1.numpy().tobytes() == x0.numpy().tobytes()
    assert branch.limit_cap.tobytes() == cap.tobytes()


# ---- the command line --------------------------------------------------


def test_cli_report_matches_jax_cli(tmp_path):
    args = ["--synthetic", "--nodes", "4", "--pending", "3",
            "--rollout", str(T_STEPS), "--workload", "diurnal",
            "--variants", '[{"name": "x", "price_scale": 2.0}]']
    reps = {}
    for pkg in PKG:
        out = tmp_path / f"{pkg}.json"
        extra = ["--device", "cpu"] if pkg == "torch" else []
        assert _mod(pkg, "whatif.cli").main(
            args + extra + ["--out", str(out)]) == 0
        reps[pkg] = json.loads(out.read_text())
    ref, got = reps["jax"], reps["torch"]
    assert got["lanes"] == ref["lanes"] == 2
    assert got["variants"] == ref["variants"]
    assert got["laneDigests"] == ref["laneDigests"]
    assert got["rollout"]["trajectoryDigests"] \
        == ref["rollout"]["trajectoryDigests"]
    assert got["summary"][0]["deltas"]["scaleupCost"] == 0.0
    for r_row, p_row in zip(ref["summary"], got["summary"]):
        assert p_row["best"] == r_row["best"]
        assert p_row["scaleupCost"] == pytest.approx(r_row["scaleupCost"],
                                                     rel=1e-6)


@pytest.mark.parametrize("entry", ["synthetic_branch", "branch_from_journal",
                                   "cli"])
def test_entry_points_raise_without_cuda(entry, monkeypatch, tmp_path):
    """With no device given, each entry point asks for CUDA and raises on a
    machine without it, before it runs any loop."""
    from kubernetes_autoscaler_tpu_torch.whatif import cli, synthetic
    from kubernetes_autoscaler_tpu_torch.whatif.variants import (
        branch_from_journal,
    )

    jdir = str(tmp_path / "journal")
    if entry == "branch_from_journal":
        _fake, a = synthetic.synthetic_autoscaler(journal_dir=jdir,
                                                  device="cpu")
        a.run_once(now=1000.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "synthetic_branch":
            synthetic.synthetic_branch()
        elif entry == "branch_from_journal":
            branch_from_journal(jdir)
        else:
            cli.main(["--synthetic", "--out", str(tmp_path / "r.json")])

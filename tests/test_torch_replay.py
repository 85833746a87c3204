"""The port's flight journal and replay harness against the JAX package's.

Lockstep: both packages' loops run `test_torch_loop`'s world and churn
script with `journal_dir`, and their records carry equal surface digests and
world digests loop for loop (record digests differ: a record's seal covers
its `backend` block). A journal either package recorded replays through the
other's harness without drift; the port's fused recording replays phased; a
forced drift gives the port the same localization report as the JAX harness;
the replay command line's exit codes; a torn tail and rotation; and the
journal names the device the loop runs on, not whichever the machine has.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from test_torch_loop import (  # noqa: F401  (an autouse fixture)
    _autoscaler,
    _churn,
    _mod,
    _one_torch_thread,
    _world,
)

LOOPS = 6


def _record(pkg: str, jdir: str, loops: int = LOOPS, **kw):
    fake = _world(pkg)
    a = _autoscaler(pkg, fake, journal_dir=jdir, **kw)
    for loop in range(loops):
        _churn(pkg, fake, loop)
        a.run_once(now=1000.0 + 10 * loop)
    a.journal.close()
    return a


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    """One journal per package, recorded in lockstep on the same world."""
    root = tmp_path_factory.mktemp("journals")
    out = {}
    for pkg in ("jax", "torch"):
        out[pkg] = str(root / pkg)
        _record(pkg, out[pkg])
    return out


def _load(pkg: str, jdir: str):
    return _mod(pkg, "replay.harness").load_journal(jdir)


def test_journals_agree_surface_for_surface_with_jax(journals):
    _, ref, _ = _load("jax", journals["jax"])
    meta, got, problems = _load("torch", journals["torch"])
    assert problems == []
    assert [r["kind"] for r in got] == ["snapshot"] + ["delta"] * (LOOPS - 1)
    assert len(ref) == len(got) == LOOPS
    for r, g in zip(ref, got):
        assert g["loop"] == r["loop"]
        assert g["digests"] == r["digests"], g["loop"]
        assert g["worldDigest"] == r["worldDigest"], g["loop"]
        assert g["backend"]["platform"] == "cpu"
        assert g["backend"]["pack"] == "plain"
    assert meta["backend"]["platform"] == "cpu"
    # the burst of loop 4 scaled up in both
    assert got[4]["outputs"]["scaleUp"]["scaledUp"]


@pytest.mark.parametrize("recorder, replayer", [("jax", "torch"),
                                                ("torch", "jax")])
def test_journal_replays_across_packages_with_zero_drift(
        journals, recorder, replayer):
    kw = {"device": "cpu"} if replayer == "torch" else {}
    rep = _mod(replayer, "replay.harness").replay_journal(
        journals[recorder], **kw)
    assert rep["zeroDrift"] is True, rep["records"]
    assert rep["loops"] == LOOPS
    _, records, _ = _load(recorder, journals[recorder])
    for rec, entry in zip(records, rep["records"]):
        assert entry["surfaces"] == rec["digests"]
    if replayer == "torch":
        assert rep["backend"]["replayed"]["platform"] == "cpu"
        assert rep["backend"]["replayed"]["pack"] == "plain"


def test_fused_recording_replays_phased_with_zero_drift(journals):
    rep = _mod("torch", "replay.harness").replay_journal(
        journals["torch"], options_override={"fused_loop": False},
        device="cpu")
    assert rep["zeroDrift"] is True, rep["records"]
    modes = [(e["fusedMode"]["recorded"], e["fusedMode"]["replayed"])
             for e in rep["records"]]
    assert modes == [("fused", "phased")] * LOOPS


def _taint_drift_journal(pkg: str, jdir: str) -> None:
    """test_replay.py's forced drift: record two loops of one node and one
    pending pod, then NoSchedule-taint the node inside the snapshot record,
    re-seal and re-chain."""
    rj = _mod(pkg, "replay.journal")
    t = _mod(pkg, "utils.testing")
    fake = _mod(pkg, "utils.fakecluster").FakeCluster()
    fake.add_node_group("ng1", t.build_test_node(
        "tmpl", cpu_milli=4000, mem_mib=8192, pods=32), min_size=0,
        max_size=0)
    fake.add_existing_node("ng1", t.build_test_node(
        "n0", cpu_milli=4000, mem_mib=8192, pods=32))
    fake.add_pod(t.build_test_pod("r0", cpu_milli=3000, mem_mib=1024,
                                  owner_name="rs", node_name="n0"))
    fake.add_pod(t.build_test_pod("p0", cpu_milli=500, mem_mib=256,
                                  owner_name="prs"))
    a = _autoscaler(pkg, fake, journal_dir=jdir)
    for k in range(2):
        a.run_once(now=1000.0 + 10.0 * k)
    a.journal.close()
    path = os.path.join(jdir, "journal-000000.jsonl")
    lines = [json.loads(ln) for ln in open(path)]
    idx = prev = None
    with open(path, "w") as f:
        for rec in lines:
            if rec.get("kind") == "snapshot":
                rec["world"]["nodes"][0]["taints"] = [
                    {"key": "drift/flip", "value": "1",
                     "effect": "NoSchedule"}]
                idx = rj.index_from_snapshot(rec["world"])
                rec["worldDigest"] = idx.digest()
                rj.seal_record(rec)
            elif rec.get("kind") == "delta":
                rec["parent"] = prev
                idx = rj.apply_world_delta(idx, rec.get("delta", {}))
                rec["worldDigest"] = idx.digest()
                rj.seal_record(rec)
            if rec.get("kind") in ("snapshot", "delta"):
                prev = rec["digest"]
            f.write(rj.canonical(rec) + "\n")


def test_forced_drift_report_equals_jax(tmp_path):
    """The twin of test_replay.py's drift localization: the same perturbed
    journal, replayed by each harness, gives the same drift loops, verdict
    diff and reason-plane diff, naming p0's group, node n0 and the taint
    bit."""
    reports = {}
    for pkg in ("jax", "torch"):
        jdir = str(tmp_path / pkg)
        _taint_drift_journal(pkg, jdir)
        kw = {"device": "cpu"} if pkg == "torch" else {}
        reports[pkg] = _mod(pkg, "replay.harness").replay_journal(jdir, **kw)
    ref, got = reports["jax"], reports["torch"]
    assert got["zeroDrift"] is False
    assert got["driftLoops"] == ref["driftLoops"] == [0, 1]
    for r, g in zip(ref["records"], got["records"]):
        for key in ("drift", "verdictDiff", "reasonDiff", "scaleUpDiff",
                    "drainDiff", "surfaces"):
            assert g.get(key) == r.get(key), key
    e0 = got["records"][0]
    gi = e0["verdictDiff"][0]["group"]
    hits = [d for d in e0["reasonDiff"]
            if d["group"] == gi and d["node"] == "n0"]
    assert hits[0]["exemplarPod"] == "p0"
    assert hits[0]["flipped"] == ["taint"]


def test_replay_cli_exit_codes(journals, tmp_path, capsys, monkeypatch):
    main = _mod("torch", "replay.__main__").main
    out = str(tmp_path / "report.json")
    assert main([journals["torch"], "--device", "cpu", "--out", out]) == 0
    assert json.loads(open(out).read())["zeroDrift"] is True
    assert main([str(tmp_path / "nothing"), "--device", "cpu"]) == 1
    drifted = str(tmp_path / "drifted")
    _taint_drift_journal("torch", drifted)
    assert main([drifted, "--device", "cpu"]) == 2
    capsys.readouterr()
    # without --device the replay runs on the card, and raises without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([journals["torch"]])


def test_torn_trailing_line_is_tolerated(journals, tmp_path):
    src = os.path.join(journals["torch"], "journal-000000.jsonl")
    dst = tmp_path / "torn"
    dst.mkdir()
    text = open(src).read().rstrip("\n")
    (dst / "journal-000000.jsonl").write_text(text[:-40] + "\n")
    harness = _mod("torch", "replay.harness")
    _, records, problems = harness.load_journal(str(dst))
    assert any(p["kind"] == "torn-tail" for p in problems)
    assert len(records) == LOOPS - 1
    rep = harness.replay_journal(str(dst), device="cpu")
    assert rep["zeroDrift"] is True
    assert rep["loops"] == LOOPS - 1


def test_rotation_drop_accounting_and_state_horizon(tmp_path):
    """test_replay.py's world of four full nodes (nothing to scale or
    drain, so a replay from past the state horizon has no lost clock to
    drift on), twelve loops under a 20 KB bound."""
    t = _mod("torch", "utils.testing")
    fake = _mod("torch", "utils.fakecluster").FakeCluster()
    fake.add_node_group("ng1", t.build_test_node(
        "tmpl", cpu_milli=4000, mem_mib=8192, pods=32), min_size=0,
        max_size=4)
    for i in range(4):
        nd = t.build_test_node(f"n{i}", cpu_milli=4000, mem_mib=8192,
                               pods=32)
        fake.add_existing_node("ng1", nd)
        fake.add_pod(t.build_test_pod(f"r{i}", cpu_milli=3200, mem_mib=1024,
                                      owner_name="rs", node_name=nd.name))
    jdir = str(tmp_path / "j")
    a = _autoscaler("torch", fake, journal_dir=jdir, journal_max_mb=0.02)
    for k in range(12):
        a.run_once(now=1000.0 + 10.0 * k)
    w, reg = a.journal, a.metrics
    assert w.rotations > 0 and w.drops.get("rotated", 0) > 0
    assert reg.counter("journal_records_total").value() == 12
    assert reg.counter("journal_rotations_total").value() == w.rotations
    assert reg.counter("journal_dropped_total").value(reason="rotated") == \
        w.drops["rotated"]
    assert reg.counter("journal_bytes_total").value() == w.bytes
    rep = _mod("torch", "replay.harness").replay_journal(jdir, device="cpu")
    assert rep["zeroDrift"] is True, rep["records"]
    assert rep["firstLoop"] > 0
    assert rep["stateHorizon"] == rep["firstLoop"]
    assert rep["loops"] == 12 - rep["firstLoop"]


def test_journal_names_the_loops_device_not_the_machines(tmp_path,
                                                         monkeypatch):
    """On a machine with a card, a loop run on the CPU records "cpu" and
    the plain pack; a CUDA device records the card and the kernel."""
    rj = _mod("torch", "replay.journal")
    t = _mod("torch", "utils.testing")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    opts = _mod("torch", "config.options").AutoscalingOptions()
    w = rj.JournalWriter(str(tmp_path / "j"), options=opts, device="cpu")
    w.begin([t.build_test_node("n0")], [], [], now=1.0)
    w.commit({"verdict": {}, "scaleUp": None, "reasons": {}, "drain": {}})
    w.close()
    lines = [json.loads(ln) for ln in
             open(tmp_path / "j" / "journal-000000.jsonl")]
    assert [ln["kind"] for ln in lines] == ["meta", "snapshot"]
    for ln in lines:
        assert ln["backend"]["platform"] == "cpu"
        assert ln["backend"]["device"] == "cpu"
        assert ln["backend"]["pack"] == "plain"
    card = rj.backend_identity(torch.device("cuda"))
    assert (card["platform"], card["device"], card["pack"]) == (
        "gpu", "NVIDIA H100 80GB HBM3", "kernel")


def test_aborted_loop_drops_staged_record(tmp_path):
    t = _mod("torch", "utils.testing")
    fake = _mod("torch", "utils.fakecluster").FakeCluster()
    fake.add_node_group("ng1", t.build_test_node("tmpl"), min_size=0,
                        max_size=4)
    fake.add_existing_node("ng1", t.build_test_node("n0", ready=False))
    a = _autoscaler("torch", fake, journal_dir=str(tmp_path / "j"),
                    scale_up_from_zero=False)
    assert a.run_once(now=1000.0).ran is False
    assert a.journal.records == 0
    assert a.journal.drops == {"aborted-loop": 1}

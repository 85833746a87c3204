"""The port's process entry: flags, leader election, the loop driver and
`python -m kubernetes_autoscaler_tpu_torch` itself.

The port's flag parser gives the same AutoscalingOptions as the reference's
for the same argv, and knows the same flags; the flag-parity table has no
flag in both buckets; a second holder is kept off the lease; the driver
re-runs at once after a productive loop and survives a raising one; and
`main([...], device="cpu")` runs a scenario end to end with the journal
and the shadow audit on while its mux serves /healthz and /whyz (without a
device it runs on the card, and raises without one).
"""

from __future__ import annotations

import dataclasses
import json
import socket
import threading
import time
import urllib.request

import pytest
import torch

from test_torch_loop import _mod, _one_torch_thread  # noqa: F401 (autouse)

# tests/test_flags_main.py's argv
ARGVS = {
    "defaults": [],
    "mapped": ["--scan-interval", "30s",
               "--expander", "priority,least-waste",
               "--scale-down-unneeded-time", "5m",
               "--max-nodes-total", "500",
               "--cores-total", "0:1000",
               "--balance-similar-node-groups", "true",
               "--cloud-config", "/etc/cloud.conf"],
    "loop": ["--node-shape-bucket", "256", "--group-shape-bucket", "64",
             "--max-new-nodes-static", "256", "--max-pods-per-node", "16",
             "--drain-chunk", "256", "--journal-dir", "j",
             "--journal-max-mb", "1024", "--shadow-audit=true",
             "--device-profile-dir", "p"],
}


@pytest.mark.parametrize("argv", list(ARGVS), ids=list(ARGVS))
def test_parse_options_equals_reference(argv):
    ref, ref_args = _mod("jax", "config.flags").parse_options(ARGVS[argv])
    got, got_args = _mod("torch", "config.flags").parse_options(ARGVS[argv])
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert vars(got_args) == vars(ref_args)


def test_parser_knows_the_reference_flags_and_parity_table_holds():
    def flags(pkg):
        p = _mod(pkg, "config.flags").build_parser()
        return sorted(s for a in p._actions for s in a.option_strings)

    assert flags("torch") == flags("jax")
    parity = _mod("torch", "config.flag_parity")
    parity.check_no_overlap()
    assert parity.REJECTED == _mod("jax", "config.flag_parity").REJECTED


def test_leader_election_excludes_second_holder(tmp_path):
    le = _mod("torch", "utils.leaderelection")
    lease = str(tmp_path / "leader.lock")
    a = le.FileLeaderElector(lease, retry_period_s=0.05)
    b = le.FileLeaderElector(lease, retry_period_s=0.05)
    assert a.try_acquire()
    assert not b.try_acquire()
    a.release()
    assert b.try_acquire()
    b.release()


def test_run_loop_reruns_after_a_productive_loop_and_survives_errors():
    sa = _mod("torch", "core.static_autoscaler")
    loop = _mod("torch", "core.loop")
    orch = _mod("torch", "core.scaleup.orchestrator")
    calls = []

    class Stub:
        options = _mod("torch", "config.options").AutoscalingOptions()
        supervisor = None

        def run_once(self):
            calls.append(time.monotonic())
            if len(calls) == 3:
                raise RuntimeError("boom")
            return sa.RunOnceStatus(
                scale_up=orch.ScaleUpResult(scaled_up=True))

    trigger = loop.LoopTrigger(scan_interval_s=60.0)
    trigger.poke()            # the first wait returns at once
    t0 = time.monotonic()
    hist = loop.run_loop(Stub(), trigger, max_iterations=3,
                         error_backoff_initial_s=0.0)
    assert time.monotonic() - t0 < 30.0       # no 60 s tick was waited
    assert [h.ran for h in hist] == [True, True, False]
    assert hist[2].error == "RuntimeError: boom"


def _scenario(tmp_path) -> str:
    scenario = {
        "node_groups": [{"id": "ng1", "min": 0, "max": 10,
                         "template": {"cpu_milli": 4000, "mem_mib": 8192}}],
        "nodes": [{"group": "ng1", "name": "n1", "cpu_milli": 4000,
                   "mem_mib": 8192}],
        "pods": [{"name": f"p{i}", "cpu_milli": 1500, "mem_mib": 512,
                  "owner_name": "rs"} for i in range(4)]
                + [{"name": "r0", "cpu_milli": 500, "mem_mib": 512,
                    "owner_name": "rs0", "node_name": "n1"}],
    }
    path = tmp_path / "scenario.json"
    path.write_text(json.dumps(scenario))
    return str(path)


def test_main_runs_a_scenario_and_serves_healthz_and_whyz(tmp_path):
    main = _mod("torch", "__main__").main
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    jdir = tmp_path / "journal"
    rc = []
    t = threading.Thread(target=lambda: rc.append(main([
        "--scenario", _scenario(tmp_path), "--max-iterations", "6",
        "--scan-interval", "50ms", "--address", f"127.0.0.1:{port}",
        "--leader-elect-lease-file", str(tmp_path / "lease.lock"),
        "--journal-dir", str(jdir), "--shadow-audit=true",
        "--node-shape-bucket", "16", "--group-shape-bucket", "16",
        "--max-new-nodes-static", "32",
        "--scale-down-delay-after-add", "0s",
        "--scale-down-unneeded-time", "0s"], device="cpu")))
    t.start()
    got = {}
    deadline = time.time() + 60
    while time.time() < deadline and t.is_alive() and len(got) < 2:
        for path in ("/healthz", "/whyz"):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{path}", timeout=2) as r:
                    body = r.read()
                    if path == "/healthz" or json.loads(body).get("loops"):
                        got[path] = (r.status, body)
            except OSError:
                pass
        time.sleep(0.02)
    t.join(timeout=120)
    assert not t.is_alive()
    assert rc == [0]
    assert got["/healthz"] == (200, b"ok")
    assert got["/whyz"][0] == 200
    # the journal it wrote replays on the CPU without drift
    rep = _mod("torch", "replay.harness").replay_journal(str(jdir),
                                                         device="cpu")
    assert rep["zeroDrift"] is True and rep["loops"] == 6
    assert rep["audit"]["divergences"] == 0


def test_main_without_a_device_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _mod("torch", "__main__").main([
            "--scenario", _scenario(tmp_path), "--max-iterations", "1",
            "--address", "127.0.0.1:0",
            "--leader-elect-lease-file", str(tmp_path / "lease.lock")])

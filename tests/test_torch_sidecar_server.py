"""The port's sidecar over gRPC, on the CPU: a round trip through
`make_grpc_server` and `SimulatorClient` answers what the service answers
in-process, rejections carry their status codes (INVALID_ARGUMENT for a bad
request, RESOURCE_EXHAUSTED with a retry-after for a full tenant table),
and the command line serves TLS on a generated pair, printing the banner
the port's `main` prints. Skips without grpcio (and, for TLS, without
cryptography); the command line's refusal to run without a device needs
neither."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from test_torch_sidecar import NGS, _strip, _world_writer

ROOT = Path(__file__).resolve().parents[1]
PORT = "kubernetes_autoscaler_tpu_torch"


@pytest.fixture(scope="module")
def served():
    pytest.importorskip("grpc")
    from kubernetes_autoscaler_tpu_torch.sidecar.server import (
        SimulatorService,
        make_grpc_server,
    )

    svc = SimulatorService(node_bucket=16, group_bucket=16, pod_bucket=32,
                           batch_lanes=2, batch_window_ms=5.0,
                           max_tenants=3, device="cpu")
    server, port = make_grpc_server(svc, port=0)
    server.start()
    yield svc, port
    server.stop(None)
    svc.close()


def test_grpc_round_trip_equals_in_process(served):
    from kubernetes_autoscaler_tpu_torch.sidecar.server import (
        SimParams,
        SimulatorClient,
    )

    svc, port = served
    client = SimulatorClient(port, tenant="a")
    ack = client.apply_delta(_world_writer("torch", 3))
    assert ack == {"version": 1, "error": ""}
    assert client.health()["status"] == "SERVING"
    up = client.scale_up_sim(node_groups=NGS, max_new_nodes=16)
    assert client.last_lifecycle is not None      # popped off the payload
    assert up == _strip(svc.scale_up_sim(
        SimParams(node_groups=NGS, max_new_nodes=16), tenant="a"))
    down = client.scale_down_sim(threshold=0.45)
    assert down == _strip(svc.scale_down_sim(SimParams(threshold=0.45),
                                             tenant="a"))
    variants = [{"name": "half-price", "price_scale": 0.5}]
    rep = client.what_if(variants=variants, node_groups=NGS,
                         max_new_nodes=16)
    body = json.dumps({"node_groups": NGS, "max_new_nodes": 16,
                       "variants": variants, "rollout": 0}).encode()
    assert rep == _strip(svc.what_if(body, tenant="a"))
    assert 'method="ScaleUpSim"' in client.metricz()
    assert "tenants:" in client.statusz()


def test_rejections_carry_their_status_codes(served):
    import grpc

    from kubernetes_autoscaler_tpu_torch.sidecar.admission import QueueFull
    from kubernetes_autoscaler_tpu_torch.sidecar.server import SimulatorClient

    svc, port = served
    bad = SimulatorClient(port, tenant="a", retry_attempts=1)
    with pytest.raises(grpc.RpcError) as e:
        bad.scale_down_sim(threshold=-1.0)
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert "negative-request" in e.value.details()
    # the table holds the default tenant, "a" and one more
    svc._tenant("a")
    SimulatorClient(port, tenant="b").apply_delta(_world_writer("torch", 4))
    full = SimulatorClient(port, tenant="c", queue_retry_attempts=0)
    with pytest.raises(QueueFull) as e:
        full.apply_delta(_world_writer("torch", 5))
    assert e.value.retry_after_ms == 1000
    assert svc.registry.counter("admission_rejects_total").value(
        reason="tenant-cap") >= 1


def test_command_line_needs_a_device(monkeypatch):
    from kubernetes_autoscaler_tpu_torch.sidecar import server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        server.main(["--port", "0"])


def test_command_line_serves_tls_with_self_signed_dir(tmp_path):
    """python -m kubernetes_autoscaler_tpu_torch.sidecar.server --device
    cpu --self-signed-cert-dir D binds TLS on a generated pair, prints
    `(tls; batch_lanes=8)` as the port's main prints it, and answers
    Health over TLS."""
    pytest.importorskip("grpc")
    pytest.importorskip("cryptography")
    from kubernetes_autoscaler_tpu_torch.sidecar.server import SimulatorClient

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    cert_dir = tmp_path / "certs"
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PORT}.sidecar.server", "--device", "cpu",
         "--port", "0", "--self-signed-cert-dir", str(cert_dir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT)
    try:
        line = ""
        deadline = time.time() + 120
        while time.time() < deadline and proc.poll() is None:
            line = proc.stdout.readline()
            if not line or "listening" in line:
                break
        m = re.search(r":(\d+) \(tls; batch_lanes=8\)$", line.strip())
        assert m, (line, proc.poll())
        client = SimulatorClient(int(m.group(1)),
                                 cert_file=str(cert_dir / "tls.crt"))
        assert client.health()["status"] == "SERVING"
    finally:
        proc.terminate()
        proc.wait(timeout=10)

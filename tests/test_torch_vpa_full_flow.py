"""Full-VPA closed loop on the port (reference: test/e2e/v1/full_vpa.go, and
the JAX package's tests/test_vpa_full_flow.py): usage samples → recommender
(its banks on the CPU) → updater evicts the divergent pod → the recreated pod
passes through the admission WEBHOOK SERVER and comes out resized. The
recommendation and the patch equal the JAX package's on the same samples.
"""

import base64
import dataclasses
import http.client
import json

from kubernetes_autoscaler_tpu.vpa import admission_server as ref_admission_server
from kubernetes_autoscaler_tpu.vpa import model as ref_model
from kubernetes_autoscaler_tpu.vpa import recommender as ref_recommender
from kubernetes_autoscaler_tpu.vpa import updater as ref_updater

from kubernetes_autoscaler_tpu_torch.vpa.admission_server import (
    AdmissionServer,
    AdmissionService,
)
from kubernetes_autoscaler_tpu_torch.vpa.model import (
    ContainerUsageSample,
    VerticalPodAutoscaler,
)
from kubernetes_autoscaler_tpu_torch.vpa.recommender import AggregateKey, Recommender
from kubernetes_autoscaler_tpu_torch.vpa.updater import PodView, Updater

MIB = 1024.0 * 1024.0


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def _admission_review_pod(name, owner, cpu_req):
    return {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "request": {
            "uid": "uid-1",
            "kind": {"kind": "Pod"},
            "namespace": "default",
            "object": {
                "metadata": {"name": name, "namespace": "default",
                             "ownerReferences": [{"name": owner}]},
                "spec": {"containers": [{
                    "name": "app",
                    "resources": {"requests": {"cpu": cpu_req,
                                               "memory": 64 * MIB}},
                }]},
            },
        },
    }


def test_full_vpa_closed_loop():
    # --- 1. recommender learns from sustained high usage ---
    rec = Recommender(device="cpu")
    vpa = VerticalPodAutoscaler(name="v", target_name="web", min_replicas=1)
    samples = [
        ContainerUsageSample(namespace="default", pod_name=f"web-{i}",
                             container_name="app", owner_name="web",
                             cpu_cores=2.0, memory_bytes=512 * MIB,
                             timestamp=float(i))
        for i in range(200)
    ]
    rec.feed(samples, now=200.0)
    rec.recommend([vpa], {"web": ["app"]}, now=200.0)
    assert vpa.recommendation
    target_cpu = vpa.recommendation[0].target["cpu"]
    assert target_cpu > 1.0  # ~2 cores observed

    # --- 2. updater decides the under-provisioned pod must be replaced ---
    evicted = []
    upd = Updater(evict=lambda p: evicted.append(p.name))
    pod = PodView(name="web-0", namespace="default", owner_name="web",
                  containers={"app": {"cpu": 0.1, "memory": 64 * MIB}},
                  replicas_of_owner=2)
    acted = upd.run_once([vpa], [pod], now=300.0)
    assert evicted == ["web-0"]
    assert acted and acted[0].outside_bounds

    # --- 3. the recreated pod is admitted through the webhook SERVER and
    #        lands with the recommended requests ---
    server = AdmissionServer(AdmissionService([vpa]))
    server.start()
    try:
        status, review = _post(server.port, "/mutate-pods",
                               _admission_review_pod("web-0-new", "web", 0.1))
        assert status == 200
        resp = review["response"]
        assert resp["allowed"] and resp["uid"] == "uid-1"
        patch = json.loads(base64.b64decode(resp["patch"]))
        cpu_ops = [p for p in patch if p["path"].endswith("/requests/cpu")]
        assert cpu_ops and abs(cpu_ops[0]["value"] - target_cpu) < 1e-9
    finally:
        server.stop()

    # --- 4. the JAX package's loop on the same samples: the same
    #        recommendation, the same eviction, the same patch ---
    ref_vpa = ref_model.VerticalPodAutoscaler(name="v", target_name="web",
                                              min_replicas=1)
    ref = ref_recommender.Recommender()
    ref.feed([ref_model.ContainerUsageSample(**dataclasses.asdict(s))
              for s in samples], now=200.0)
    ref.recommend([ref_vpa], {"web": ["app"]}, now=200.0)
    assert ([dataclasses.asdict(r) for r in ref_vpa.recommendation]
            == [dataclasses.asdict(r) for r in vpa.recommendation])
    ref_evicted = []
    ref_updater.Updater(evict=lambda p: ref_evicted.append(p.name)).run_once(
        [ref_vpa], [ref_updater.PodView(**dataclasses.asdict(pod))], now=300.0)
    assert ref_evicted == evicted
    ref_server = ref_admission_server.AdmissionServer(
        ref_admission_server.AdmissionService([ref_vpa]))
    ref_server.start()
    try:
        _, ref_review = _post(ref_server.port, "/mutate-pods",
                              _admission_review_pod("web-0-new", "web", 0.1))
        assert ref_review == review
    finally:
        ref_server.stop()


def test_webhook_validates_vpa_objects():
    server = AdmissionServer(AdmissionService([]))
    server.start()
    try:
        bad = {
            "request": {
                "uid": "u2",
                "kind": {"kind": "VerticalPodAutoscaler"},
                "object": {"metadata": {"name": "v"},
                           "spec": {"targetRef": {"name": ""}}},
            }
        }
        status, review = _post(server.port, "/validate-vpa", bad)
        assert status == 200
        assert review["response"]["allowed"] is False
        assert "targetRef" in review["response"]["status"]["message"]

        good = {
            "request": {
                "uid": "u3",
                "kind": {"kind": "VerticalPodAutoscaler"},
                "object": {"metadata": {"name": "v"},
                           "spec": {"targetRef": {"name": "web"}}},
            }
        }
        _, review = _post(server.port, "/validate-vpa", good)
        assert review["response"]["allowed"] is True
    finally:
        server.stop()


def test_webhook_rejects_malformed_body():
    server = AdmissionServer(AdmissionService([]))
    server.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
        conn.request("POST", "/mutate-pods", "{not json",
                     {"Content-Type": "application/json"})
        assert conn.getresponse().status == 400
        conn.close()
    finally:
        server.stop()

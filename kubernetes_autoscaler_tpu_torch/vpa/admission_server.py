"""VPA admission webhook SERVER: the AdmissionReview HTTP surface.

Reference counterpart: vertical-pod-autoscaler/pkg/admission-controller/
logic/server.go — a mutating webhook for pods (patch container requests to the
matching VPA's recommendation) and a validating webhook for VPA objects. The
reference additionally self-manages its serving certificate
(certs/manager.go); here TLS is injected (pass an ssl.SSLContext or cert/key
paths) because certificate issuance belongs to the deployment, not the
decision logic. The request/response wire shape is the k8s
admission.k8s.io/v1 AdmissionReview JSON, base64-JSONPatch response included,
so a real apiserver could call this endpoint unmodified.
"""

from __future__ import annotations

import base64
import json
import ssl
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kubernetes_autoscaler_tpu_torch.vpa.admission import patch_for_pod, validate_vpa
from kubernetes_autoscaler_tpu_torch.vpa.model import VerticalPodAutoscaler


_QUANTITY_SUFFIX = {
    "m": 1e-3, "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
}


def parse_quantity(v) -> float:
    """k8s resource.Quantity string → float ('100m' → 0.1, '128Mi' → bytes).
    Real AdmissionReview pods carry quantity STRINGS, never bare numbers."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    for suf in ("Ki", "Mi", "Gi", "Ti", "Pi", "m", "k", "M", "G", "T", "P"):
        if s.endswith(suf):
            return float(s[: -len(suf)]) * _QUANTITY_SUFFIX[suf]
    return float(s)


def _jsonpatch_from_ops(ops, container_index: dict[str, int]) -> list[dict]:
    """PatchOps → RFC-6902 ops against the pod spec. Containers are a JSON
    ARRAY, so paths must use the container's INDEX, not its name (reference:
    resource/pod/patch emits /spec/containers/<i>/...); `add` upserts whether
    or not the requests/limits key already exists."""
    patches = []
    for op in ops:
        idx = container_index.get(op.container)
        if idx is None:
            continue
        if op.resource.startswith("limit:"):
            res = op.resource.split(":", 1)[1]
            path = f"/spec/containers/{idx}/resources/limits/{res}"
        else:
            path = f"/spec/containers/{idx}/resources/requests/{op.resource}"
        patches.append({"op": "add", "path": path, "value": op.value})
    return patches


class AdmissionService:
    """Transport-independent webhook logic; the HTTP handler is a thin shim."""

    def __init__(self, vpas: list[VerticalPodAutoscaler] | None = None):
        self.vpas = list(vpas or [])

    def review(self, body: dict) -> dict:
        req = body.get("request", {})
        uid = req.get("uid", "")
        kind = (req.get("kind") or {}).get("kind", "")
        obj = req.get("object") or {}
        if kind == "Pod":
            response = self._mutate_pod(req, obj)
        elif kind == "VerticalPodAutoscaler":
            response = self._validate_vpa(obj)
        else:
            response = {"allowed": True}
        response["uid"] = uid
        return {"apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview", "response": response}

    def _mutate_pod(self, req: dict, pod: dict) -> dict:
        meta = pod.get("metadata", {})
        namespace = req.get("namespace") or meta.get("namespace", "default")
        owners = meta.get("ownerReferences") or []
        owner = owners[0]["name"] if owners else meta.get("name", "")
        containers = {}
        limits = {}
        container_index: dict[str, int] = {}
        for i, c in enumerate(pod.get("spec", {}).get("containers", [])):
            container_index[c["name"]] = i
            res = c.get("resources", {})
            containers[c["name"]] = {
                k: parse_quantity(v) for k, v in (res.get("requests") or {}).items()}
            limits[c["name"]] = {
                k: parse_quantity(v) for k, v in (res.get("limits") or {}).items()}
        ops = patch_for_pod(namespace, owner, containers, limits, self.vpas)
        if not ops:
            return {"allowed": True}
        patch = json.dumps(_jsonpatch_from_ops(ops, container_index)).encode()
        return {"allowed": True, "patchType": "JSONPatch",
                "patch": base64.b64encode(patch).decode()}

    def _validate_vpa(self, obj: dict) -> dict:
        vpa = VerticalPodAutoscaler(
            name=obj.get("metadata", {}).get("name", ""),
            namespace=obj.get("metadata", {}).get("namespace", "default"),
            target_name=(obj.get("spec", {}).get("targetRef") or {}).get("name", ""),
        )
        problems = validate_vpa(vpa)
        if problems:
            return {"allowed": False,
                    "status": {"message": "; ".join(problems)}}
        return {"allowed": True}


class AdmissionServer:
    """The serving shell (reference: admission-controller main.go + server.go).

    TLS modes (the apiserver requires TLS in real deployments):
      * certfile/keyfile          — operator-provisioned material
      * self_signed_cert_dir      — the server generates AND ROTATES its own
                                    serving certificate there (reference: the
                                    admission controller's cert
                                    self-management, certs/; round-3 review
                                    item #7). Rotation reloads the live
                                    SSLContext — new handshakes pick up the
                                    fresh pair without rebinding.
      * neither                   — plain HTTP (tests/dev only)."""

    def __init__(self, service: AdmissionService, host: str = "127.0.0.1",
                 port: int = 0, certfile: str | None = None,
                 keyfile: str | None = None,
                 self_signed_cert_dir: str | None = None,
                 cert_valid_days: float = 365.0,
                 rotate_before_s: float = 30 * 24 * 3600.0):
        svc = service
        self.cert_manager = None
        if not certfile and self_signed_cert_dir:
            from kubernetes_autoscaler_tpu_torch.utils.certs import CertManager

            self.cert_manager = CertManager(
                self_signed_cert_dir,
                common_name=host if host not in ("", "0.0.0.0") else "localhost",
                valid_days=cert_valid_days, rotate_before_s=rotate_before_s)
            certfile = self.cert_manager.cert_path
            keyfile = self.cert_manager.key_path

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                if self.path not in ("/mutate-pods", "/validate-vpa", "/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                length = int(self.headers.get("Content-Length", "0"))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                    out = json.dumps(svc.review(body)).encode()
                    code = 200
                except (ValueError, KeyError) as e:
                    out = json.dumps({"error": str(e)}).encode()
                    code = 400
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self._ssl_ctx = None
        if certfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile, keyfile)
            self.httpd.socket = ctx.wrap_socket(self.httpd.socket,
                                                server_side=True)
            self._ssl_ctx = ctx
            if self.cert_manager is not None:
                # rotations reload the serving context in place
                self.cert_manager.on_reload(
                    lambda c, k: self._ssl_ctx.load_cert_chain(c, k))
        self._thread: threading.Thread | None = None

    def rotate_certs_if_needed(self, now: float | None = None) -> bool:
        """Run periodically by the deployment loop (or a timer): regenerates
        the self-signed serving pair when it nears expiry and hot-reloads
        the TLS context. No-op for operator-provisioned certs."""
        if self.cert_manager is None:
            return False
        return self.cert_manager.ensure(now)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

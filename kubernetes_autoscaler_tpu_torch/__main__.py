"""Process entry: flags → leader election → HTTP mux → control loop.

Reference counterpart: cluster-autoscaler/main.go:200-331 — flag parsing,
leader election, the /metrics /healthz /snapshotz HTTP mux, then the loop
driver. Standalone mode runs against a JSON scenario file on the in-memory
provider (the reference's equivalent harness is the kwok/test provider);
deployment mode is driven through the sidecar gRPC service instead
(sidecar/server.py).

Scenario JSON shape:
{
  "node_groups": [{"id": "ng1", "min": 0, "max": 10,
                   "template": {"cpu_milli": 4000, "mem_mib": 8192, ...}}],
  "nodes":  [{"group": "ng1", "name": "n1", "cpu_milli": 4000, ...}],
  "pods":   [{"name": "p1", "cpu_milli": 500, "mem_mib": 512,
              "owner_name": "rs", "node_name": ""}]
}
"""

from __future__ import annotations

import json
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kubernetes_autoscaler_tpu_torch.config.flags import parse_options
from kubernetes_autoscaler_tpu_torch.core.loop import LoopTrigger, run_loop
from kubernetes_autoscaler_tpu_torch.core.static_autoscaler import StaticAutoscaler
from kubernetes_autoscaler_tpu_torch.debuggingsnapshot import DebuggingSnapshotter
from kubernetes_autoscaler_tpu_torch.metrics.metrics import (
    default_registry,
    expose_all_text,
)
from kubernetes_autoscaler_tpu_torch.utils.fakecluster import FakeCluster
from kubernetes_autoscaler_tpu_torch.utils.leaderelection import FileLeaderElector
from kubernetes_autoscaler_tpu_torch.utils.testing import build_test_node, build_test_pod


def cluster_from_scenario(path: str) -> FakeCluster:
    with open(path) as f:
        doc = json.load(f)
    fake = FakeCluster()
    for g in doc.get("node_groups", []):
        t = dict(g.get("template", {}))
        name = t.pop("name", f"template-{g['id']}")
        tmpl = build_test_node(name, **t)
        fake.add_node_group(g["id"], tmpl, min_size=g.get("min", 0),
                            max_size=g.get("max", 10))
    for n in doc.get("nodes", []):
        spec = {k: v for k, v in n.items() if k not in ("group",)}
        fake.add_existing_node(n["group"], build_test_node(**spec))
    for p in doc.get("pods", []):
        fake.add_pod(build_test_pod(**p))
    return fake


def make_mux(autoscaler: StaticAutoscaler, snapshotter: DebuggingSnapshotter):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # klog-quiet
            pass

        def _send(self, code: int, body: str, ctype="text/plain"):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/metrics":
                # default registry + any registered extra registries (an
                # in-process sidecar's katpu_sidecar_* series) — the same
                # families the sidecar Metricz RPC serves, one scrape.
                # OpenMetrics content type: histogram bucket lines may carry
                # exemplar suffixes (`# {trace_id="…"} v`), which are
                # OpenMetrics syntax — a classic text/plain parser would
                # reject the whole scrape
                self._send(200, expose_all_text(),
                           ctype="application/openmetrics-text; "
                                 "version=1.0.0; charset=utf-8")
            elif self.path == "/healthz":
                ok = autoscaler.health.healthy()
                self._send(200 if ok else 500, "ok" if ok else "loop stalled")
            elif self.path == "/statusz":
                st = autoscaler.last_status
                self._send(200, st.to_json() if st else "{}",
                           "application/json")
            elif self.path == "/snapshotz":
                if snapshotter is None:
                    self._send(404, "debugging snapshots disabled "
                                    "(--debugging-snapshot-enabled=false)")
                    return
                handle = snapshotter.request_snapshot()
                payload = handle.wait(timeout=120.0)
                self._send(200 if payload else 504, payload or "timed out",
                           "application/json")
            elif self.path == "/whyz" or self.path.startswith("/whyz?"):
                # decision lineage (lineage/index.py, docs/LINEAGE.md):
                #   /whyz                 → per-object summary digest
                #   /whyz?object=K/NAME   → that object's causal chain
                #   /whyz?loop=K          → object-level diff across K
                ring = autoscaler.lineage_ring
                if ring is None:
                    self._send(404, "lineage ring disabled "
                                    "(--lineage-ring=false)")
                    return
                from urllib.parse import parse_qs, urlparse

                from kubernetes_autoscaler_tpu_torch.lineage import query as lq
                qs = parse_qs(urlparse(self.path).query)
                if qs.get("object"):
                    kind, name = lq.parse_object(qs["object"][0])
                    body = ring.why(kind, name, surface="whyz")
                    body["segments"] = lq.coalesce_segments(
                        body.get("entries") or [])
                elif qs.get("loop"):
                    try:
                        body = ring.diff(int(qs["loop"][0]),
                                         surface="whyz")
                    except ValueError:
                        self._send(400, "loop must be an integer")
                        return
                else:
                    body = ring.snapshot_summary(surface="whyz")
                self._send(200, json.dumps(body, indent=2, sort_keys=True,
                                           default=str),
                           "application/json")
            elif self.path == "/profilez":
                # --profiling consumer (reference: net/http/pprof behind
                # --profiling, main.go:264-266): per-phase wall-time stats
                # from the function_duration histograms as JSON
                if not autoscaler.options.profiling:
                    self._send(404, "profiling disabled (--profiling=false)")
                    return
                import json as _json

                h = default_registry.histogram("function_duration_seconds")
                out = {}
                for key in list(h._sums):
                    label = dict(key).get("function", "?")
                    out[label] = {
                        "count": int(sum(h._counts.get(key, []))),
                        "sum_seconds": h._sums.get(key, 0.0),
                    }
                self._send(200, _json.dumps(out, indent=2),
                           "application/json")
            else:
                self._send(404, "not found")

    return Handler


def main(argv: list[str] | None = None, device=None) -> int:
    """The process entry. The loop runs on `device` (None = CUDA, raising
    without a card; the tests pass "cpu")."""
    options, args = parse_options(argv)
    if not args.scenario:
        print("standalone mode needs --scenario <file>; deployment mode is "
              "driven via the sidecar gRPC service (sidecar/server.py)")
        return 2

    fake = cluster_from_scenario(args.scenario)
    snapshotter = (DebuggingSnapshotter()
                   if options.debugging_snapshot_enabled else None)
    autoscaler = StaticAutoscaler(
        fake.provider, fake, options=options, eviction_sink=fake,
        debugging_snapshotter=snapshotter, device=device,
    )

    host, _, port = args.address.rpartition(":")
    server = ThreadingHTTPServer((host or "0.0.0.0", int(port)),
                                 make_mux(autoscaler, snapshotter))
    threading.Thread(target=server.serve_forever, daemon=True).start()

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            pass  # non-main thread (tests)

    def run():
        trigger = LoopTrigger(options.scan_interval_s)
        max_it = args.max_iterations or None
        run_loop(autoscaler, trigger, max_iterations=max_it, stop=stop)
        return 0

    try:
        if args.leader_elect:
            elector = FileLeaderElector(args.leader_elect_lease_file)
            rc = elector.run_or_die(run, stop=stop)
            return 0 if rc is None else rc   # stop during standby = clean exit
        return run()
    finally:
        server.shutdown()
        autoscaler.provider.cleanup()


if __name__ == "__main__":
    raise SystemExit(main())

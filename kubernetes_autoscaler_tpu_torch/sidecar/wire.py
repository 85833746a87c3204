"""KAD1 wire serialization: api objects → snapshot-delta bytes.

The client half of the sidecar boundary (a Go control plane implements the
same trivial format; see native/kacodec.cc header for the byte layout). This
is the versioned snapshot-diff protocol SURVEY.md §7 calls for — per loop the
control plane sends only changed nodes/pods instead of re-uploading the world
(the reference's DeltaSnapshotStore idea, delta.go:33-54, moved to the wire).
"""

from __future__ import annotations

import struct

from kubernetes_autoscaler_tpu_torch.models import resources as res
from kubernetes_autoscaler_tpu_torch.models.api import (
    NO_EXECUTE,
    NO_SCHEDULE,
    Node,
    Pod,
)
from kubernetes_autoscaler_tpu_torch.models.encode import (
    equivalence_key,
    node_capacity_vector,
    pod_request_vector,
)

MAGIC = b"KAD1"

# Trace context rides gRPC request metadata under this key — NEVER the KAD1
# body or KAUX trailer. The dense bytes stay trace-free so committed goldens
# (tests/test_wire_conformance.py) and independent Go encoders are untouched
# by whether the caller happens to be tracing; the server echoes its child
# spans back in the RESPONSE json ("trace" field), also off-wire-format.
TRACE_ID_HEADER = "katpu-trace-id"

# Tenant identity for the multi-tenant serving sidecar (docs/SERVING.md)
# rides request metadata exactly like the trace id — NEVER the KAD1 bytes,
# so single-tenant encoders (the committed goldens, the Go shim) are
# untouched. Absent/empty header = the default tenant: the pre-multi-tenant
# wire behavior, byte-for-byte.
TENANT_ID_HEADER = "katpu-tenant-id"

# Backpressure: a RESOURCE_EXHAUSTED rejection carries its retry hint in
# trailing metadata under this key (milliseconds, decimal string).
RETRY_AFTER_MS_HEADER = "katpu-retry-after-ms"

# Snapshot-version pinning for ApplyDelta (decimal string): a client that
# tracks its server-side world version stamps the version its delta was
# built AGAINST here; a mismatch (most importantly: the server restarted
# and holds version 0 or a rehydrated world) rejects INVALID_ARGUMENT with
# reason `section-version-mismatch` instead of silently applying a delta to
# the wrong base snapshot — the client's signal to full-resend
# (docs/ROBUSTNESS.md, warm restart).
BASE_VERSION_HEADER = "katpu-base-version"

# Per-tenant SLO budget declaration (milliseconds, decimal string): a client
# that knows its own loop deadline stamps it here; the server registers it
# as the tenant's latency budget (sidecar/lifecycle.SloBudgets) and counts
# `tenant_slo_breaches_total{tenant}` against it — metadata only, the KAD1
# bytes stay SLO-free like trace/tenant identity above.
SLO_BUDGET_MS_HEADER = "katpu-slo-budget-ms"

UPSERT_NODE, DELETE_NODE, UPSERT_POD, DELETE_POD = 1, 2, 3, 4

_EFFECTS = {NO_SCHEDULE: 0, NO_EXECUTE: 1}


def _s(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    out += struct.pack("<H", len(b))
    out += b


AUX_MAGIC = b"KAUX"


class DeltaWriter:
    def __init__(self, registry: res.ExtendedResourceRegistry | None = None):
        self.registry = registry or res.ExtendedResourceRegistry()
        self._body = bytearray()
        self._count = 0
        # constraint side-channel (v1.1): topology-coupled pod specs the dense
        # KAD1 rows cannot carry ride a trailer the C++ codec skips (it reads
        # exactly `count` ops) and the PYTHON sidecar consumes — so sidecar-fed
        # clusters get the device constrained tier instead of blanket
        # host-checking. Labels ship for every labeled pod: they are the
        # TARGETS of other pods' selectors (plane counting).
        self._aux_upserts: dict[str, dict] = {}
        self._aux_deletes: list[str] = []

    def upsert_node(self, node: Node, group_id: int = -1) -> "DeltaWriter":
        b = self._body
        b.append(UPSERT_NODE)
        _s(b, node.name)
        b += struct.pack("<H", len(node.labels))
        for k, v in node.labels.items():
            _s(b, k)
            _s(b, v)
        taints = node.taints
        b.append(len(taints))
        for t in taints:
            _s(b, t.key)
            _s(b, t.value)
            b.append(_EFFECTS.get(t.effect, 2))
        cap = node_capacity_vector(node, self.registry)
        b += struct.pack(f"<{res.NUM_RESOURCES}i", *cap.tolist())
        b.append((1 if node.ready else 0) | (2 if node.unschedulable else 0))
        b += struct.pack("<i", group_id)
        _s(b, node.zone())
        self._count += 1
        return self

    def delete_node(self, name: str) -> "DeltaWriter":
        self._body.append(DELETE_NODE)
        _s(self._body, name)
        self._count += 1
        return self

    def upsert_pod(self, pod: Pod, movable: bool = False,
                   blocks: bool = False) -> "DeltaWriter":
        b = self._body
        b.append(UPSERT_POD)
        _s(b, pod.uid or f"{pod.namespace}/{pod.name}")
        _s(b, pod.node_name)
        req, req_lossy = pod_request_vector(pod, self.registry)
        b += struct.pack(f"<{res.NUM_RESOURCES}i", *req.tolist())
        sel = sorted(pod.node_selector.items())
        b += struct.pack("<H", len(sel))
        for k, v in sel:
            _s(b, k)
            _s(b, v)
        b.append(len(pod.tolerations))
        for t in pod.tolerations:
            _s(b, t.key)
            b.append(1 if t.operator == "Exists" else 0)
            _s(b, t.value)
            b.append(_EFFECTS.get(t.effect, 2) if t.effect else 2)
        b.append(len(pod.host_ports))
        for port, proto in pod.host_ports:
            b += struct.pack("<H", port)
            b.append(1 if proto == "UDP" else 0)
        anti_self = any(
            term.topology_key == "kubernetes.io/hostname"
            and term.match_labels
            and all(pod.labels.get(k) == v for k, v in term.match_labels.items())
            for term in pod.anti_affinity
        )
        # lossy mirrors _encode_pod_spec: shapes the dense wire can't express.
        # Uses the ACCESSORS so both the legacy sugar fields and the full
        # list forms (topology_spread, node_affinity_terms, resource_claims)
        # route to the host-check tier rather than silently dropping.
        lossy = bool(
            req_lossy
            or pod.affinity_node_terms()
            or pod.pod_affinity
            or pod.spread_constraints()
            or pod.resource_claims
            or any(not (t.topology_key == "kubernetes.io/hostname"
                        and t.match_labels
                        and all(pod.labels.get(k) == v
                                for k, v in t.match_labels.items()))
                   for t in pod.anti_affinity)
        )
        b.append((1 if movable else 0) | (2 if blocks else 0)
                 | (4 if anti_self else 0) | (8 if lossy else 0))
        eqkey = str(equivalence_key(pod))
        _s(b, eqkey)
        self._maybe_aux(pod, eqkey)
        self._count += 1
        return self

    def _maybe_aux(self, pod: Pod, eqkey: str) -> None:
        uid = pod.uid or f"{pod.namespace}/{pod.name}"
        has_topology = bool(pod.pod_affinity or pod.anti_affinity
                            or pod.spread_constraints())
        if not (has_topology or pod.labels):
            # a re-upsert that no longer qualifies must CLEAR any earlier
            # record on the server, or stale labels keep feeding the planes
            self._aux_upserts.pop(uid, None)
            if uid not in self._aux_deletes:
                self._aux_deletes.append(uid)
            return
        rec: dict = {
            "k": eqkey, "ns": pod.namespace, "l": dict(pod.labels),
            "n": pod.node_name,
            # the wire's lossy bit is CONSERVATIVE (set for any topology
            # constraint so aux-unaware servers host-check); "dok" tells the
            # overlay whether topology was the ONLY cause — i.e. the bit may
            # be cleared once the overlay models the constraints
            "dok": not (pod_request_vector(pod, self.registry)[1]
                        or pod.affinity_node_terms()
                        or pod.resource_claims),
        }
        cons = pod.spread_constraints()
        if cons:
            c = cons[0]
            # matchLabelKeys merges into "sel" AT THE ENCODER (the Go shim
            # does the same — common.go:96-104 is a static per-pod merge);
            # minDomains / non-default inclusion policies ride as fields the
            # overlay routes to the exact host-check tier
            rec["s"] = {"key": c.topology_key, "w": int(c.max_skew),
                        "sel": dict(c.merged_selector(pod.labels)),
                        "extra": len(cons) > 1,
                        "md": int(c.min_domains),
                        "nap": c.node_affinity_policy,
                        "ntp": c.node_taints_policy}
        if pod.pod_affinity:
            t = pod.pod_affinity[0]
            rec["a"] = {"key": t.topology_key, "sel": dict(t.match_labels),
                        "nss": list(t.namespaces),
                        "nssel": (dict(t.namespace_selector)
                                  if t.namespace_selector is not None
                                  else None),
                        "extra": len(pod.pod_affinity) > 1}
        if pod.anti_affinity:
            rec["x"] = [{"key": t.topology_key, "sel": dict(t.match_labels),
                         "nss": list(t.namespaces),
                         "nssel": (dict(t.namespace_selector)
                                   if t.namespace_selector is not None
                                   else None)}
                        for t in pod.anti_affinity]
        # within-payload coherence: a uid lives in exactly ONE list, with the
        # LAST op winning (the server applies upserts then deletes, so mixed
        # membership would net to deletion regardless of op order)
        if uid in self._aux_deletes:
            self._aux_deletes.remove(uid)
        self._aux_upserts[uid] = rec

    def delete_pod(self, uid: str) -> "DeltaWriter":
        self._body.append(DELETE_POD)
        _s(self._body, uid)
        self._aux_upserts.pop(uid, None)
        if uid not in self._aux_deletes:
            self._aux_deletes.append(uid)
        self._count += 1
        return self

    def payload(self) -> bytes:
        import json
        import zlib

        out = MAGIC + struct.pack("<I", self._count) + bytes(self._body)
        if self._aux_upserts or self._aux_deletes:
            doc = json.dumps({"up": self._aux_upserts,
                              "del": self._aux_deletes}).encode()
            # reverse-parsable trailer: [json][u32 len][u32 crc32][KAUX];
            # the crc makes a coincidental 'KAUX' suffix in a plain payload
            # statistically impossible to mis-split
            out += (doc + struct.pack("<I", len(doc))
                    + struct.pack("<I", zlib.crc32(doc)) + AUX_MAGIC)
        return out


def split_aux(payload: bytes) -> tuple[bytes, dict | None]:
    """(KAD1 bytes for the C++ codec, parsed aux doc or None). A malformed or
    coincidental trailer (bad length / crc / json shape) yields the payload
    unchanged — never a truncated dense body."""
    import json
    import zlib

    if len(payload) < 12 or payload[-4:] != AUX_MAGIC:
        return payload, None
    (crc,) = struct.unpack("<I", payload[-8:-4])
    (n,) = struct.unpack("<I", payload[-12:-8])
    if n > len(payload) - 12:
        return payload, None
    doc_bytes = payload[-12 - n:-12]
    if zlib.crc32(doc_bytes) != crc:
        return payload, None
    try:
        doc = json.loads(doc_bytes)
    except ValueError:
        return payload, None
    if not isinstance(doc, dict) or not set(doc) <= {"up", "del"}:
        return payload, None
    return payload[: len(payload) - 12 - n], doc

"""Go-test fixture exporter: golden scenarios as stdlib-readable files.

The Go encoder (`go/katpusim/kad1.go`) must produce byte-identical KAD1
bodies and semantically-equal KAUX trailers for the conformance scenarios
(docs/SIDECAR_WIRE.md §Conformance). This image ships no Go toolchain (r4
verdict Missing #3), so the fixtures are exported in forms `go test` can
consume with the standard library alone:

  go/katpusim/testdata/<scenario>.json        — per-delta writer-call records
  go/katpusim/testdata/<scenario>_<i>.bin     — the committed payload bytes

The records are DECODED BACK from the Python writer's own bytes (not
re-lowered), so exporter drift is impossible: whatever the Python encoder
wrote is exactly what the Go replay is asked to reproduce.

Regenerate after a wire change:  python -m kubernetes_autoscaler_tpu_torch.sidecar.go_fixtures
"""

from __future__ import annotations

import json
import os
import struct

from kubernetes_autoscaler_tpu_torch.models import resources as res
from kubernetes_autoscaler_tpu_torch.sidecar.wire import (
    DELETE_NODE,
    DELETE_POD,
    MAGIC,
    UPSERT_NODE,
    UPSERT_POD,
)

GO_TESTDATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "go", "katpusim", "testdata")


def split_payload(payload: bytes) -> tuple[int, bytes, dict | None]:
    """(record count, KAD1 body, aux doc or None)."""
    assert payload[:4] == MAGIC
    count = struct.unpack_from("<I", payload, 4)[0]
    rest = payload[8:]
    aux = None
    if rest.endswith(b"KAUX"):
        doc_len, _crc = struct.unpack_from("<II", rest, len(rest) - 12)
        doc = rest[len(rest) - 12 - doc_len: len(rest) - 12]
        aux = json.loads(doc.decode())
        rest = rest[: len(rest) - 12 - doc_len]
    return count, rest, aux


def _rstr(b: bytes, o: int) -> tuple[str, int]:
    n = struct.unpack_from("<H", b, o)[0]
    return b[o + 2: o + 2 + n].decode(), o + 2 + n


def decode_records(body: bytes, count: int) -> list[dict]:
    """KAD1 body → writer-call records (the Go test's replay inputs)."""
    out: list[dict] = []
    o = 0
    r = res.NUM_RESOURCES
    for _ in range(count):
        op = body[o]
        o += 1
        if op == UPSERT_NODE:
            name, o = _rstr(body, o)
            n_lbl = struct.unpack_from("<H", body, o)[0]
            o += 2
            labels = []
            for _i in range(n_lbl):
                k, o = _rstr(body, o)
                v, o = _rstr(body, o)
                labels.append([k, v])
            n_taints = body[o]
            o += 1
            taints = []
            for _i in range(n_taints):
                k, o = _rstr(body, o)
                v, o = _rstr(body, o)
                taints.append({"key": k, "value": v, "effect": body[o]})
                o += 1
            cap = list(struct.unpack_from(f"<{r}i", body, o))
            o += 4 * r
            flags = body[o]
            o += 1
            group_id = struct.unpack_from("<i", body, o)[0]
            o += 4
            zone, o = _rstr(body, o)
            out.append({"op": "upsert_node", "name": name, "labels": labels,
                        "taints": taints, "cap": cap,
                        "ready": bool(flags & 1),
                        "unschedulable": bool(flags & 2),
                        "group_id": group_id, "zone": zone})
        elif op == DELETE_NODE:
            name, o = _rstr(body, o)
            out.append({"op": "delete_node", "name": name})
        elif op == UPSERT_POD:
            uid, o = _rstr(body, o)
            node, o = _rstr(body, o)
            req = list(struct.unpack_from(f"<{r}i", body, o))
            o += 4 * r
            n_sel = struct.unpack_from("<H", body, o)[0]
            o += 2
            sel = []
            for _i in range(n_sel):
                k, o = _rstr(body, o)
                v, o = _rstr(body, o)
                sel.append([k, v])
            n_tol = body[o]
            o += 1
            tols = []
            for _i in range(n_tol):
                k, o = _rstr(body, o)
                exists = bool(body[o])
                o += 1
                v, o = _rstr(body, o)
                tols.append({"key": k, "exists": exists, "value": v,
                             "effect": body[o]})
                o += 1
            n_ports = body[o]
            o += 1
            ports = []
            for _i in range(n_ports):
                port = struct.unpack_from("<H", body, o)[0]
                o += 2
                ports.append({"port": port, "udp": bool(body[o])})
                o += 1
            flags = body[o]
            o += 1
            eqkey, o = _rstr(body, o)
            out.append({"op": "upsert_pod", "uid": uid, "node": node,
                        "req": req, "selector": sel, "tolerations": tols,
                        "ports": ports,
                        "movable": bool(flags & 1), "blocks": bool(flags & 2),
                        "anti_self": bool(flags & 4),
                        "lossy": bool(flags & 8), "eqkey": eqkey})
        elif op == DELETE_POD:
            uid, o = _rstr(body, o)
            out.append({"op": "delete_pod", "uid": uid})
        else:
            raise ValueError(f"unknown op {op} at offset {o - 1}")
    assert o == len(body), (o, len(body))
    return out


def export(directory: str = GO_TESTDATA) -> list[str]:
    from kubernetes_autoscaler_tpu_torch.sidecar.conformance import scenarios

    os.makedirs(directory, exist_ok=True)
    written = []
    for name, writers, _desc in scenarios():
        deltas = []
        for i, w in enumerate(writers):
            payload = w.payload()
            count, body, aux = split_payload(payload)
            records = decode_records(body, count)
            # per-pod aux records keyed by uid, so the Go replay can hand
            # each UpsertPod its AuxRecord (shape = AuxRecord json tags)
            aux_up = (aux or {}).get("up", {})
            for rec in records:
                if rec["op"] == "upsert_pod":
                    rec["aux"] = aux_up.get(rec["uid"])
            bin_name = f"{name}_{i}.bin"
            with open(os.path.join(directory, bin_name), "wb") as f:
                f.write(payload)
            deltas.append({"payload": bin_name, "records": records,
                           "aux_deletes": (aux or {}).get("del", []),
                           "has_aux": aux is not None})
        path = os.path.join(directory, f"{name}.json")
        with open(path, "w") as f:
            json.dump({"scenario": name, "deltas": deltas}, f, indent=1,
                      sort_keys=True)
        written.append(path)
    return written


if __name__ == "__main__":
    for p in export():
        print(p)

"""KAD1/KAUX wire-format conformance kit.

The sidecar boundary's contract artifacts (round-3 review item #5: "the Go
half of the sidecar boundary" — no Go toolchain exists in this image, so the
deliverable is golden fixtures a Go encoder builds against, the shape
precedent being expander/grpcplugin/protos/expander.proto:25-28):

  * `scenarios()` — deterministic builders covering the whole format surface
    (every op code, every field, the KAUX constraint trailer, multi-delta
    incremental sequences);
  * `write_goldens(dir)` — for each scenario, the exact payload bytes plus
    the tensors the native codec (sidecar/native/kacodec.cc) must decode
    them into, saved as one .npz; `manifest.json` records the semantic
    inputs so an independent (Go) encoder can reproduce the byte stream and
    byte-compare;
  * `replay(payloads)` — run payloads through the C++ codec and export.

tests/test_wire_conformance.py replays the COMMITTED goldens through the
live codec every CI run — the wire format cannot drift silently.
"""

from __future__ import annotations

import json
import os

import numpy as np

from kubernetes_autoscaler_tpu_torch.models.api import (
    AffinityTerm,
    Node,
    OwnerRef,
    Pod,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)
from kubernetes_autoscaler_tpu_torch.sidecar.wire import DeltaWriter, split_aux

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")


def _node(name, cpu=8.0, mem_gib=16, pods=64, labels=None, taints=None,
          zone="", gpus=0, ready=True, unschedulable=False):
    lbl = {"kubernetes.io/hostname": name}
    if zone:
        lbl["topology.kubernetes.io/zone"] = zone
    lbl.update(labels or {})
    cap = {"cpu": cpu, "memory": mem_gib * (1 << 30), "pods": pods}
    if gpus:
        cap["nvidia.com/gpu"] = gpus
    return Node(name=name, labels=lbl, capacity=dict(cap),
                allocatable=dict(cap), taints=list(taints or []),
                ready=ready, unschedulable=unschedulable)


def _pod(name, cpu=0.5, mem_mib=512, node="", uid="", **kw):
    p = Pod(name=name, uid=uid or f"uid-{name}",
            requests={"cpu": cpu, "memory": mem_mib * (1 << 20)},
            node_name=node, **kw)
    return p


def scenarios() -> list[tuple[str, list[DeltaWriter], str]]:
    """(name, delta writers in apply order, description)."""
    out = []

    # -- 1: node field coverage ------------------------------------------
    w = DeltaWriter()
    w.upsert_node(_node("plain"), group_id=0)
    w.upsert_node(_node(
        "full", cpu=16.0, mem_gib=64, pods=110,
        labels={"pool": "a", "disk": "ssd"},
        taints=[Taint("dedicated", "infra", "NoSchedule"),
                Taint("flaky", "", "NoExecute"),
                Taint("soft", "x", "PreferNoSchedule")],  # effect=2 (other)
        zone="us-a", gpus=4), group_id=1)
    w.upsert_node(_node("cordoned", unschedulable=True), group_id=0)
    w.upsert_node(_node("unready", ready=False), group_id=-1)
    out.append(("nodes_fields", [w],
                "every UPSERT_NODE field: labels, the three taint-effect "
                "encodings, zone, extended resource, flags byte, group_id"))

    # -- 2: pod field coverage -------------------------------------------
    w = DeltaWriter()
    w.upsert_node(_node("host-1", zone="us-a"), group_id=0)
    w.upsert_pod(_pod("resident", node="host-1"), movable=True)
    w.upsert_pod(_pod("blocker", node="host-1"), blocks=True)
    w.upsert_pod(_pod(
        "selective", node_selector={"disk": "ssd", "pool": "a"},
        tolerations=[Toleration("dedicated", "Equal", "infra", "NoSchedule"),
                     Toleration("any", "Exists", "", ""),
                     Toleration("", "Exists", "", "")],  # tolerate-everything
        host_ports=((8080, "TCP"), (53, "UDP"))))
    anti = _pod("anti-self", labels={"app": "web"})
    anti.anti_affinity = [AffinityTerm(match_labels={"app": "web"},
                                       topology_key="kubernetes.io/hostname")]
    w.upsert_pod(anti)
    out.append(("pods_fields", [w],
                "UPSERT_POD fields: resident vs pending, movable/blocks "
                "flags, selectors, the three toleration encodings, TCP/UDP "
                "hostPorts, the anti_affinity_self + lossy flag bits, and "
                "the KAUX trailer the labeled pods produce"))

    # -- 3: equivalence groups + alloc charging ---------------------------
    w = DeltaWriter()
    w.upsert_node(_node("h1"), group_id=0)
    w.upsert_node(_node("h2"), group_id=0)
    rs = OwnerRef(kind="ReplicaSet", name="rs-twins", uid="uid-rs-twins")
    for i in range(3):
        w.upsert_pod(_pod(f"twin-{i}", uid=f"uid-twin-{i}", owner=rs),
                     movable=True)
    # same spec → same eqkey string → one group row, count 3
    for i in range(2):
        w.upsert_pod(_pod(f"res-{i}", cpu=1.0, mem_mib=1024,
                          node=f"h{i + 1}"))
    out.append(("equivalence_and_alloc", [w],
                "identical pending specs share one equivalence row "
                "(count=3); resident pods charge node alloc"))

    # -- 4: incremental delta sequence ------------------------------------
    w1 = DeltaWriter()
    w1.upsert_node(_node("n1", zone="us-a"), group_id=0)
    w1.upsert_node(_node("n2", zone="us-b"), group_id=0)
    w1.upsert_pod(_pod("p1", node="n1"), movable=True)
    w1.upsert_pod(_pod("p2"))
    w2 = DeltaWriter()
    w2.upsert_pod(_pod("p2", node="n2"), movable=True)   # pending → bound
    w2.delete_pod("uid-p1")
    w2.upsert_node(_node("n1", zone="us-a", unschedulable=True),
                   group_id=0)                            # cordon in place
    w3 = DeltaWriter()
    w3.delete_node("n2")                                  # residents released
    out.append(("incremental_sequence", [w1, w2, w3],
                "three deltas: bind, delete-pod, node update in place, "
                "node delete (its resident pod returns to pending)"))

    # -- 5: KAUX constraint records (incl. round-4 fields) ----------------
    w = DeltaWriter()
    w.upsert_node(_node("z1", zone="us-a"), group_id=0)
    spread = _pod("spreader", labels={"app": "web", "rev": "r1"})
    spread.topology_spread = [TopologySpreadConstraint(
        max_skew=2, topology_key="topology.kubernetes.io/zone",
        match_labels={"app": "web"}, match_label_keys=("rev",))]
    w.upsert_pod(spread)
    exotic = _pod("exotic", labels={"app": "api"})
    exotic.topology_spread = [TopologySpreadConstraint(
        max_skew=1, topology_key="topology.kubernetes.io/zone",
        match_labels={"app": "api"}, min_domains=3,
        node_taints_policy="Honor")]
    w.upsert_pod(exotic)
    nsaff = _pod("nsaff", labels={"app": "db"})
    nsaff.pod_affinity = [AffinityTerm(
        match_labels={"app": "web"},
        topology_key="topology.kubernetes.io/zone",
        namespace_selector={"tier": "prod"})]
    w.upsert_pod(nsaff)
    out.append(("aux_constraints", [w],
                "KAUX trailer: merged matchLabelKeys selector, md/nap/ntp "
                "fields, namespace_selector (nssel) on an affinity term"))
    return out


def _writer_manifest(w: DeltaWriter) -> dict:
    """Human/Go-readable digest of one delta: op count + aux doc."""
    payload = w.payload()
    body, aux = split_aux(payload)
    return {
        "bytes": len(payload),
        "kad1_bytes": len(body),
        "records": int.from_bytes(body[4:8], "little"),
        "aux": aux,
    }


def replay(payloads: list[bytes], dims=None):
    """Apply payloads through the native codec; return (state, exports)."""
    from kubernetes_autoscaler_tpu_torch.models.cluster_state import DEFAULT_DIMS
    from kubernetes_autoscaler_tpu_torch.sidecar.native_api import (
        NativeSnapshotState,
    )

    st = NativeSnapshotState(dims or DEFAULT_DIMS)
    for p in payloads:
        body, _aux = split_aux(p)
        st.apply_delta(body)
    nodes, groups, pods = st.export(node_bucket=16, group_bucket=8,
                                    pod_bucket=16)
    return st, (nodes, groups, pods)


def write_goldens(directory: str = GOLDEN_DIR) -> list[str]:
    os.makedirs(directory, exist_ok=True)
    manifest = {}
    names = []
    for name, writers, desc in scenarios():
        payloads = [w.payload() for w in writers]
        st, (nodes, groups, pods) = replay(payloads)
        arrays = {f"payload_{i}": np.frombuffer(p, np.uint8)
                  for i, p in enumerate(payloads)}
        arrays.update({f"nodes.{k}": v for k, v in nodes.items()})
        arrays.update({f"groups.{k}": v for k, v in groups.items()})
        arrays.update({f"pods.{k}": v for k, v in pods.items()})
        n, p, g = st.counts()
        arrays["counts"] = np.array([n, p, g, st.version], np.int64)
        np.savez(os.path.join(directory, f"{name}.npz"), **arrays)
        manifest[name] = {
            "description": desc,
            "deltas": [_writer_manifest(w) for w in writers],
            "counts": {"nodes": n, "pods": p, "groups": g,
                       "version": st.version},
        }
        names.append(name)
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return names


if __name__ == "__main__":  # regenerate: python -m kubernetes_autoscaler_tpu_torch.sidecar.conformance
    for n in write_goldens():
        print(f"wrote {os.path.join(GOLDEN_DIR, n)}.npz")

"""JournalWriter: every RunOnce as a self-contained, replayable record.

The journal is the provenance layer under the trace/reason/metric surfaces
(PRs 3/4/8): those say what a loop LOOKED like; the journal lets you take
the loop offline and re-execute it. Record format (JSONL, one object per
line, one file per rotation window):

  meta line   {"kind": "meta", "options": {...}, "config": fp, ...}
              — first line of every file; carries the full
              AutoscalingOptions so a replay runs under the recorded
              config, not whatever the harness defaults to.
  record      {"v": 1, "loop": k, "kind": "snapshot" | "delta",
               "parent": <digest of record k-1>, "now": <loop now>,
               "config": <options fingerprint>, "backend": {...},
               "world" | "delta": {...}, "worldDigest": <digest>,
               "outputs": {...}, "digests": {verdict, scaleUp, reasons,
               drain}, "digest": <record digest>}

World encoding: the source view at the TOP of the loop (nodes, pods as
listed, node-group states incl. membership), serialized object-per-object
in listing order. A delta carries only added/deleted/modified objects
against the previous record; the writer REPLAYS its own delta before
committing and falls back to a full snapshot if the reconstruction is not
digest-identical — every committed record reconstructs exactly, by
construction. Digests are sha256/16hex over a canonical JSON encoding, so
they are process- and platform-independent.

Bounded by --journal-max-mb with rotation (each file re-opens with a meta
line + full snapshot, so any retained file is independently replayable)
and drop accounting (`journal_dropped_total{reason}`).

`TenantJournal` is the sidecar's per-tenant analog: a bounded in-memory
ring of delta/verdict provenance records, persisted only on an SLO breach
or backpressure (the TailSampler retention pattern), capped like the
tenant table.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque

import numpy as np

from kubernetes_autoscaler_tpu_torch.models.api import (
    AffinityTerm,
    Node,
    NodeSelectorRequirement,
    OwnerRef,
    Pod,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)

JOURNAL_VERSION = 1
_FILE_PREFIX = "journal-"
_FILE_SUFFIX = ".jsonl"

_RECORDS_HELP = "Flight-journal records committed"
_BYTES_HELP = "Flight-journal bytes appended"
_ROTATIONS_HELP = "Flight-journal file rotations"
_DROPPED_HELP = "Flight-journal records dropped, by reason"


# ---- canonical encoding + digests ----
#
# One shared implementation (utils/canonical.py) for the journal AND the
# device-resident WorldStore (models/world_store.py): both must agree on
# what "changed" means, by construction — re-exported here because the
# journal is the historical home these names are imported from.

from kubernetes_autoscaler_tpu_torch.utils.canonical import (  # noqa: F401
    canon_map as _canon_map,
    canonical,
    digest_of,
    digest_strs as _digest_strs,
)


def backend_identity(device=None, node_bucket: int | None = None,
                     group_bucket: int | None = None) -> dict:
    """Backend + shape-class identity stamped into every record — the
    cross-backend divergence oracle compares records ACROSS these.
    `device` is the one the loop runs on (None = CUDA, raising without a
    card), not whichever the machine has: a CPU loop on a machine with a
    card records "cpu" and the plain pack."""
    import torch

    from kubernetes_autoscaler_tpu_torch.device import resolve_device

    device = resolve_device(device)
    cuda = device.type == "cuda"
    out = {"platform": "gpu" if cuda else "cpu",
           "device": torch.cuda.get_device_name(device) if cuda else "cpu",
           "torch": torch.__version__,
           "pack": "kernel" if cuda else "plain"}
    if node_bucket is not None:
        out["shape"] = {"nodeBucket": int(node_bucket),
                        "groupBucket": int(group_bucket or 0)}
    return out


def options_fingerprint(options) -> str:
    return digest_of(dataclasses.asdict(options))


# ---- world serialization (object boundary ↔ JSON) ----

def node_to_dict(nd: Node) -> dict:
    return dataclasses.asdict(nd)


def node_from_dict(d: dict) -> Node:
    d = dict(d)
    d["taints"] = [Taint(**t) for t in d.get("taints", [])]
    return Node(**d)


def pod_to_dict(p: Pod) -> dict:
    return dataclasses.asdict(p)


def _nsr(d: dict) -> NodeSelectorRequirement:
    d = dict(d)
    d["values"] = tuple(d.get("values", ()))
    return NodeSelectorRequirement(**d)


def _aff_term(d: dict) -> AffinityTerm:
    d = dict(d)
    d["namespaces"] = tuple(d.get("namespaces", ()))
    return AffinityTerm(**d)


def pod_from_dict(d: dict) -> Pod:
    d = dict(d)
    d["required_node_affinity"] = [_nsr(x)
                                   for x in d.get("required_node_affinity", [])]
    d["node_affinity_terms"] = [[_nsr(x) for x in term]
                                for term in d.get("node_affinity_terms", [])]
    d["tolerations"] = [Toleration(**t) for t in d.get("tolerations", [])]
    d["host_ports"] = tuple((int(p), proto)
                            for p, proto in d.get("host_ports", ()))
    d["anti_affinity"] = [_aff_term(t) for t in d.get("anti_affinity", [])]
    d["pod_affinity"] = [_aff_term(t) for t in d.get("pod_affinity", [])]
    spreads = []
    for c in d.get("topology_spread", []):
        c = dict(c)
        c["match_label_keys"] = tuple(c.get("match_label_keys", ()))
        spreads.append(TopologySpreadConstraint(**c))
    d["topology_spread"] = spreads
    owner = d.get("owner")
    d["owner"] = OwnerRef(**owner) if owner else None
    d["pvc_refs"] = tuple(d.get("pvc_refs", ()))
    d["resource_claims"] = tuple(d.get("resource_claims", ()))
    return Pod(**d)


def groups_state(provider, nodes: list[Node]) -> list[dict]:
    """Node-group states at the top of the loop: sizes, template, price and
    node membership (replay needs membership to rebuild
    node_group_for_node)."""
    members: dict[str, list[str]] = {}
    for nd in nodes:
        g = provider.node_group_for_node(nd)
        if g is not None:
            members.setdefault(g.id(), []).append(nd.name)
    out = []
    for g in provider.node_groups():
        if not g.exist():
            continue
        out.append({
            "id": g.id(),
            "min": int(g.min_size()),
            "max": int(g.max_size()),
            "target": int(g.target_size()),
            "price": float(getattr(g, "price_per_node", 1.0)),
            "template": node_to_dict(g.template_node_info()),
            "members": members.get(g.id(), []),
        })
    return out


# ---- the outputs surface (shared verbatim by recorder and replayer) ----

def collect_outputs(autoscaler, status) -> dict:
    """One loop's decision surfaces, exactly as the loop computed them:
    the filter-out-schedulable verdict plane (per-group scheduled counts,
    byte-preserved), the scale-up verdict incl. the chosen expansion
    option, the reason plane (NoScaleUp groups with constraint bits,
    unremovable nodes, drain-failure attribution) and the drain decisions.
    The recorder digests this dict; the replay harness rebuilds it from the
    re-executed loop with THIS SAME function, so digest equality means the
    decisions match byte for byte."""
    plane = getattr(autoscaler, "last_verdict_plane", None)
    verdict = {
        "pending": int(status.pending_pods),
        "groups": int(plane.shape[0]) if plane is not None else 0,
        "scheduledHex": (plane.astype("<i4").tobytes().hex()
                         if plane is not None else ""),
    }
    su = status.scale_up
    scale_up = None
    if su is not None:
        best = None
        if su.best is not None:
            best = {"group": su.best.group_id,
                    "nodes": int(su.best.node_count),
                    "pods": int(su.best.pod_count),
                    "waste": float(su.best.waste),
                    "price": float(su.best.price)}
        scale_up = {"scaledUp": bool(su.scaled_up),
                    "increases": dict(sorted(su.increases.items())),
                    "errors": dict(sorted(su.errors.items())),
                    "podsHelped": int(su.pods_helped),
                    "podsRemaining": int(su.pods_remaining),
                    "best": best}
    orch = autoscaler.scale_up_orchestrator
    planner = autoscaler.planner
    reasons = {
        "noScaleUp": dict(sorted(orch.last_noscaleup.items())),
        "groups": [
            {"group": int(g["group"]), "exemplarPod": g["exemplarPod"],
             "pods": int(g["pods"]), "reason": g["reason"],
             "constraints": dict(sorted(g["constraints"].items()))}
            for g in orch.last_noscaleup_groups
        ],
        "unremovable": {n: e[1] for n, e in
                        sorted(planner.unremovable.entries.items())},
        "drainFail": dict(sorted(planner.state.drain_fail_detail.items())),
    }
    drain = {"unneeded": sorted(status.unneeded_nodes),
             "deleted": sorted(status.scale_down_deleted)}
    return {"ran": bool(status.ran), "aborted": status.aborted_reason,
            "verdict": verdict, "scaleUp": scale_up, "reasons": reasons,
            "drain": drain}


def surface_digests(outputs: dict) -> dict:
    return {
        "verdict": digest_of(outputs["verdict"]),
        "scaleUp": digest_of(outputs["scaleUp"]),
        "reasons": digest_of(outputs["reasons"]),
        "drain": digest_of(outputs["drain"]),
    }


def decode_verdict_plane(verdict: dict) -> np.ndarray:
    """The byte-preserved per-group scheduled counts back as int32[G]."""
    raw = bytes.fromhex(verdict.get("scheduledHex", ""))
    return np.frombuffer(raw, dtype="<i4").copy()


def seal_record(rec: dict) -> dict:
    """(Re)compute a record's digest over everything but the seal itself.
    Exposed so tests/tools can perturb a record and keep it structurally
    valid — the drift then shows up in the OUTPUT digests, where it
    belongs, not as a corrupted file."""
    body = {k: v for k, v in rec.items() if k != "digest"}
    rec["digest"] = digest_of(body)
    return rec


def world_digest(node_canons: list[str], pod_canons: list[str],
                 group_canons: list[str]) -> str:
    """Order-sensitive digest of the full world: listing order is part of
    the contract (the incremental encoder's row/slot assignment follows
    arrival order, so replay must present objects in the recorded order)."""
    return _digest_strs(["N", *node_canons, "P", *pod_canons,
                         "G", *group_canons])


class _WorldIndex:
    """Ordered name → canonical-JSON maps for one world (the delta base)."""

    __slots__ = ("nodes", "pods", "groups")

    def __init__(self, nodes: dict[str, str], pods: dict[str, str],
                 groups: dict[str, str]):
        self.nodes = nodes
        self.pods = pods
        self.groups = groups

    def digest(self) -> str:
        return world_digest(list(self.nodes.values()),
                            list(self.pods.values()),
                            list(self.groups.values()))


def _section_delta(prev: dict[str, str], cur: dict[str, str]
                   ) -> tuple[list, list, list]:
    """(added canon-parsed dicts, deleted keys, modified canon-parsed dicts)."""
    add, mod = [], []
    for k, c in cur.items():
        p = prev.get(k)
        if p is None:
            add.append(json.loads(c))
        elif p != c:
            mod.append(json.loads(c))
    dele = [k for k in prev if k not in cur]
    return add, dele, mod


def apply_section_delta(prev: dict[str, str], delta: dict, key_of,
                        section: str) -> dict[str, str]:
    """Rebuild one ordered section map from its predecessor + delta. Order
    contract: surviving entries keep their relative order, modified entries
    stay in place, added entries append in recorded order."""
    dele = set(delta.get(f"{section}Del", []))
    mods = {key_of(d): canonical(d) for d in delta.get(f"{section}Mod", [])}
    out: dict[str, str] = {}
    for k, c in prev.items():
        if k in dele:
            continue
        out[k] = mods.pop(k, c)
    if mods:
        # a "modified" key the base does not carry — structurally invalid
        raise ValueError(f"delta modifies unknown {section} keys: "
                         f"{sorted(mods)}")
    for d in delta.get(f"{section}Add", []):
        out[key_of(d)] = canonical(d)
    return out


def _node_key(d: dict) -> str:
    return d["name"]


def _pod_key(d: dict) -> str:
    return f"{d['namespace']}/{d['name']}"


def _group_key(d: dict) -> str:
    return d["id"]


def apply_world_delta(prev: _WorldIndex, delta: dict) -> _WorldIndex:
    return _WorldIndex(
        apply_section_delta(prev.nodes, delta, _node_key, "nodes"),
        apply_section_delta(prev.pods, delta, _pod_key, "pods"),
        apply_section_delta(prev.groups, delta, _group_key, "groups"),
    )


def snapshot_from_index(idx: _WorldIndex) -> dict:
    return {"nodes": [json.loads(c) for c in idx.nodes.values()],
            "pods": [json.loads(c) for c in idx.pods.values()],
            "groups": [json.loads(c) for c in idx.groups.values()]}


def index_from_snapshot(world: dict) -> _WorldIndex:
    return _WorldIndex(
        {_node_key(d): canonical(d) for d in world.get("nodes", [])},
        {_pod_key(d): canonical(d) for d in world.get("pods", [])},
        {_group_key(d): canonical(d) for d in world.get("groups", [])},
    )


# ---- the writer ----

class JournalWriter:
    """Append-only, size-bounded, rotating flight journal.

    Not thread-safe by design: it is owned by the control-loop thread the
    way the FlightRecorder's tracer is (one record per RunOnce, begun and
    committed on the loop)."""

    def __init__(self, dir: str, max_mb: float = 64.0, keep_files: int = 4,
                 registry=None, options=None, meta: dict | None = None,
                 device=None):
        self.dir = dir
        self.max_bytes = max(int(max_mb * 1_000_000), 10_000)
        self.keep_files = max(int(keep_files), 1)
        # each file is bounded so the RETAINED set (keep_files files)
        # respects --journal-max-mb in total
        self.rotate_bytes = max(self.max_bytes // self.keep_files, 5_000)
        self.registry = registry
        self._options = options
        self.config_fp = options_fingerprint(options) if options else ""
        self._meta_extra = meta or {}
        self._node_bucket = getattr(options, "node_shape_bucket", None)
        self._group_bucket = getattr(options, "group_shape_bucket", None)
        self._device = device
        self.loop = 0
        self.records = 0
        self.bytes = 0
        self.rotations = 0
        self.snapshot_fallbacks = 0
        self.drops: dict[str, int] = {}
        self.overhead_ns = 0
        self._prev: _WorldIndex | None = None
        self._last_digest = ""
        self._staged: dict | None = None
        self._staged_index: _WorldIndex | None = None
        # per-loop top-level record annotations, set by the autoscaler
        # before commit() and cleared after each sealed record
        self.loop_annotations: dict = {}
        # canonical-form cache keyed by OBJECT IDENTITY (value holds the
        # object reference, so a freed id can never alias — the
        # host_mirror_token pattern). Valid under the repo-wide
        # replace-on-update contract the incremental encoder already
        # rides: a changed object is a NEW object. This turns the per-loop
        # serialization cost from O(world) to O(churn).
        self._canon_nodes: dict[int, tuple] = {}
        self._canon_pods: dict[int, tuple] = {}
        self._file = None
        self._file_seq = -1
        self._file_bytes = 0
        self._file_records: dict[str, int] = {}
        os.makedirs(self.dir, exist_ok=True)

    # -- record lifecycle (begin at the top of RunOnce, commit at the end) --

    def begin(self, nodes: list[Node], pods: list[Pod], groups: list[dict],
              now: float, fidelity: dict | None = None) -> None:
        """Stage this loop's input world. Serialization happens HERE — before
        the loop body mutates anything in place (soft taints, lowering
        passes), so the record is the world the loop actually consumed."""
        t0 = time.perf_counter_ns()
        try:
            self._canon_nodes, node_map = _canon_map(
                nodes, lambda nd: nd.name, node_to_dict, self._canon_nodes)
            self._canon_pods, pod_map = _canon_map(
                pods, lambda p: f"{p.namespace}/{p.name}", pod_to_dict,
                self._canon_pods)
            cur = _WorldIndex(node_map, pod_map,
                              {g["id"]: canonical(g) for g in groups})
            wd = cur.digest()
            kind = "snapshot" if (self._prev is None or self._file is None) \
                else "delta"
            body: dict = {}
            if kind == "delta":
                delta: dict = {}
                for section, prev_m, cur_m, key_of in (
                        ("nodes", self._prev.nodes, cur.nodes, _node_key),
                        ("pods", self._prev.pods, cur.pods, _pod_key),
                        ("groups", self._prev.groups, cur.groups, _group_key)):
                    add, dele, mod = _section_delta(prev_m, cur_m)
                    if add:
                        delta[f"{section}Add"] = add
                    if dele:
                        delta[f"{section}Del"] = dele
                    if mod:
                        delta[f"{section}Mod"] = mod
                # the round-trip guarantee is enforced at WRITE time: replay
                # the delta against the previous index; any reconstruction
                # mismatch (e.g. a source re-ordering its listing) falls
                # back to a full snapshot instead of committing a record
                # that cannot reproduce its own world
                if apply_world_delta(self._prev, delta).digest() == wd:
                    body["delta"] = delta
                else:
                    kind = "snapshot"
                    self.snapshot_fallbacks += 1
            if kind == "snapshot":
                body["world"] = snapshot_from_index(cur)
            self._staged = {
                "v": JOURNAL_VERSION, "loop": self.loop, "kind": kind,
                "parent": self._last_digest, "now": float(now),
                "config": self.config_fp,
                "backend": backend_identity(self._device, self._node_bucket,
                                            self._group_bucket),
                **body,
                "worldDigest": wd,
                **({"fidelity": fidelity} if fidelity else {}),
            }
            self._staged_index = cur
        finally:
            self.overhead_ns += time.perf_counter_ns() - t0

    def commit(self, outputs: dict) -> tuple[int, str] | None:
        """Attach the loop's outputs + digests, seal, append. Returns the
        journal cursor (loop, record digest) the observability surfaces
        stamp — None when the append failed and the record was dropped."""
        t0 = time.perf_counter_ns()
        try:
            rec = self._staged
            if rec is None:
                raise RuntimeError("commit without begin")
            self._staged = None
            rec["outputs"] = outputs
            rec["digests"] = surface_digests(outputs)
            # loop-scoped annotations (fused-loop provenance: fusedMode /
            # loopDeviceRoundTrips / speculation — docs/FUSED_LOOP.md) ride
            # the record TOP LEVEL, not `outputs`: the surface digests the
            # replay drift comparison checks stay mode-independent, so a
            # record written fused replays clean on the phased oracle
            if self.loop_annotations:
                for k, v in self.loop_annotations.items():
                    rec.setdefault(k, v)
                self.loop_annotations = {}
            seal_record(rec)
            line = canonical(rec) + "\n"
            try:
                self._append(line)
            except OSError:
                # a full/readonly disk must never sink the loop — but the
                # dropped record exists in no file, so it gets NO cursor
                # (stamping its digest onto /snapshotz or the trace would
                # name provenance nothing can ever resolve)
                self._drop("io-error")
                return None
            self._prev = self._staged_index
            self._last_digest = rec["digest"]
            self.loop += 1
            self.records += 1
            nbytes = len(line)
            self.bytes += nbytes
            if self.registry is not None:
                self.registry.counter("journal_records_total",
                                      help=_RECORDS_HELP).inc()
                self.registry.counter("journal_bytes_total",
                                      help=_BYTES_HELP).inc(nbytes)
            if self._file_bytes >= self.rotate_bytes:
                self._rotate()
            return (rec["loop"], rec["digest"])
        finally:
            self.overhead_ns += time.perf_counter_ns() - t0

    def abort(self, reason: str = "aborted-loop") -> None:
        """Discard a staged record (the loop raised or returned before its
        outputs existed) — counted, never silently lost."""
        if self._staged is None:
            return
        self._staged = None
        self._drop(reason)

    def cursor(self) -> tuple[int, str] | None:
        """(loop, digest) of the last committed record."""
        if not self._last_digest:
            return None
        return (self.loop - 1, self._last_digest)

    def overhead_ms(self) -> float:
        return self.overhead_ns / 1e6

    def stats(self) -> dict:
        return {"records": self.records, "bytes": self.bytes,
                "rotations": self.rotations,
                "snapshotFallbacks": self.snapshot_fallbacks,
                "drops": dict(self.drops),
                "files": sorted(self._file_records),
                "overheadMs": round(self.overhead_ms(), 3)}

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    # -- file management --

    def _path(self, seq: int) -> str:
        return os.path.join(self.dir, f"{_FILE_PREFIX}{seq:06d}{_FILE_SUFFIX}")

    def _append(self, line: str) -> None:
        if self._file is None:
            self._open_next()
        pos = self._file.tell()
        try:
            self._file.write(line)
            self._file.flush()
        except OSError:
            # roll the file back to the pre-write offset: a torn trailing
            # fragment (ENOSPC mid-line) would otherwise concatenate with
            # the next successful record and render the WHOLE journal
            # unparseable — destroying the evidence exactly under the
            # disk-pressure conditions it must survive
            try:
                self._file.seek(pos)
                self._file.truncate()
            except OSError:
                pass
            raise
        self._file_bytes += len(line)
        path = self._path(self._file_seq)
        self._file_records[path] = self._file_records.get(path, 0) + 1

    def _open_next(self) -> None:
        existing = [f for f in os.listdir(self.dir)
                    if f.startswith(_FILE_PREFIX) and f.endswith(_FILE_SUFFIX)]
        if self._file_seq < 0 and existing:
            last = max(int(f[len(_FILE_PREFIX):-len(_FILE_SUFFIX)])
                       for f in existing)
            self._file_seq = last
        self._file_seq += 1
        path = self._path(self._file_seq)
        self._file = open(path, "w")
        meta = {
            "kind": "meta", "v": JOURNAL_VERSION,
            "config": self.config_fp,
            "backend": backend_identity(self._device, self._node_bucket,
                                        self._group_bucket),
            "createdLoop": self.loop,
            **({"options": dataclasses.asdict(self._options)}
               if self._options is not None else {}),
            **self._meta_extra,
        }
        line = canonical(meta) + "\n"
        self._file.write(line)
        self._file.flush()
        self._file_bytes = len(line)
        self.bytes += len(line)
        if self.registry is not None:
            self.registry.counter("journal_bytes_total",
                                  help=_BYTES_HELP).inc(len(line))

    def _rotate(self) -> None:
        self.close()
        self.rotations += 1
        # a rotated-into file must be independently replayable: its first
        # record re-snapshots the world
        self._prev = None
        if self.registry is not None:
            self.registry.counter("journal_rotations_total",
                                  help=_ROTATIONS_HELP).inc()
        files = sorted(
            f for f in os.listdir(self.dir)
            if f.startswith(_FILE_PREFIX) and f.endswith(_FILE_SUFFIX))
        while len(files) >= self.keep_files:
            victim = os.path.join(self.dir, files.pop(0))
            dropped = self._file_records.pop(victim, None)
            if dropped is None:
                # a predecessor run's file (reused --journal-dir): count
                # its records before pruning — the size bound applies
                # across runs, but drops are NEVER silently unaccounted.
                # The raw substring is unambiguous: canonical JSON escapes
                # quotes inside string values, so '"kind":"meta"' can only
                # be the meta line's own key.
                try:
                    with open(victim) as f:
                        dropped = sum(1 for ln in f
                                      if ln.strip()
                                      and '"kind":"meta"' not in ln)
                except OSError:
                    dropped = 0
            try:
                os.remove(victim)
            except OSError:
                break
            if dropped:
                self._drop("rotated", dropped)

    def _drop(self, reason: str, n: int = 1) -> None:
        self.drops[reason] = self.drops.get(reason, 0) + n
        if self.registry is not None:
            self.registry.counter("journal_dropped_total",
                                  help=_DROPPED_HELP).inc(n, reason=reason)


# ---- sidecar per-tenant journal ----

class TenantJournal:
    """Bounded in-memory provenance ring for one sidecar tenant: every
    ApplyDelta (the tenant's world delta stream is the KAD1 wire payload
    itself) and every sim verdict digest, chained like the on-disk journal.
    Retention follows the TailSampler pattern: nothing touches disk until a
    breach/backpressure event `persist()`s the ring next to the trace dump."""

    def __init__(self, tenant: str = "", capacity: int = 256, registry=None):
        import threading

        self.tenant = tenant or "default"
        self.capacity = max(int(capacity), 1)
        self.registry = registry
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()   # gRPC handlers + batch scheduler
        self.seq = 0
        self.records = 0
        self.bytes = 0
        self.dropped = 0
        self.persisted = 0
        self._last_digest = ""
        # maybe_persist dedup watermark: the seq already on disk
        self._persisted_seq = -1

    def record(self, kind: str, version: int, nbytes: int = 0,
               digest: str = "", extra: dict | None = None) -> tuple[int, str]:
        with self._lock:
            rec = {"seq": self.seq, "kind": kind, "version": int(version),
                   "parent": self._last_digest,
                   **({"bytes": int(nbytes)} if nbytes else {}),
                   **({"payload": digest} if digest else {}),
                   **(extra or {})}
            seal_record(rec)
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
                if self.registry is not None:
                    self.registry.counter(
                        "journal_dropped_total", help=_DROPPED_HELP,
                    ).inc(reason="evicted", tenant=self.tenant)
            self._ring.append(rec)
            self._last_digest = rec["digest"]
            self.seq += 1
            self.records += 1
            nb = len(canonical(rec))
            self.bytes += nb
        if self.registry is not None:
            self.registry.counter("journal_records_total",
                                  help=_RECORDS_HELP).inc(tenant=self.tenant)
            self.registry.counter("journal_bytes_total",
                                  help=_BYTES_HELP).inc(nb,
                                                        tenant=self.tenant)
        return (rec["seq"], rec["digest"])

    def cursor(self) -> tuple[int, str] | None:
        with self._lock:
            if not self._last_digest:
                return None
            return (self.seq - 1, self._last_digest)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def stats(self) -> dict:
        with self._lock:
            return {"tenant": self.tenant, "records": self.records,
                    "bytes": self.bytes, "held": len(self._ring),
                    "dropped": self.dropped, "persisted": self.persisted}

    def persist(self, path: str, reason: str = "") -> str:
        """Write the retained ring as JSONL (meta line first, like the main
        journal). Atomic replace; OSError propagates to the caller, which
        treats a full disk as non-fatal."""
        snaps = self.snapshot()
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            f.write(canonical({"kind": "meta", "v": JOURNAL_VERSION,
                               "tenant": self.tenant, "reason": reason,
                               "backend": backend_identity()}) + "\n")
            for rec in snaps:
                f.write(canonical(rec) + "\n")
        os.replace(tmp, path)
        with self._lock:
            self.persisted += 1
        return path

    def maybe_persist(self, dir_path: str, reason: str = "") -> str | None:
        """Persist the ring IF it grew since the last persist — the
        retention trigger (breach/backpressure) fires per REQUEST, and
        backpressure fires exactly when the server is saturated: without
        the watermark, an overload storm would write one full ring copy
        per rejected RPC. The file is keyed by (tenant, ring seq), so a
        re-persist of the same history overwrites instead of accreting."""
        with self._lock:
            seq = self.seq - 1
            if seq < 0 or seq == self._persisted_seq:
                return None
            self._persisted_seq = seq
        path = os.path.join(
            dir_path, f"journal-{self.tenant}-seq{seq:08d}.jsonl")
        return self.persist(path, reason=reason)

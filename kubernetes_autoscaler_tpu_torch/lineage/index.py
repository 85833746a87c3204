"""LineageIndex / LineageRing: (object kind, name) × loop provenance.

The index is built over the SAME record stream `replay/harness.load_journal`
parses, but with an observer's failure posture: a journal being written to,
rotated under, or torn mid-line must degrade a query, never crash it — bad
lines and bad seals become `problems` entries, and only the selected run's
chain is ingested (a dir holding several runs' files is the normal case,
replay/harness.py:57). The scan is incremental: each refresh() reads only
bytes appended since the last one, which is what makes `--follow` a tail,
not a rescan.

Per record, the object-centric entries come from the record's `outputs`
surface (replay/journal.collect_outputs — the byte-digested decision
surface, so the index derives from exactly what the loop decided):

  pod-group/<exemplar>   refused (headline reason + per-constraint refused
                         counts, the summarize_reason_row vocabulary) and
                         resolved transitions
  nodegroup/<id>         chosen expansion options (won/lost, waste, price),
                         target increases, scale-up errors
  node/<name>            unremovable reasons, drain-failure detail,
                         unneeded verdicts, scale-down actuations

Cursor stitching: every artifact stamped with the journal cursor or a
trace id resolves back to a loop of the selected run —

  audit-NNNNNN-<trace>.json        journalCursor + traceId (+ divergence
                                   detail; persistent ⇒ the derived
                                   suspect→degraded transition)
  flight-<trace>.trace.json        the RunOnce root span's journal_digest
                                   arg (chrome-trace args, metrics/trace)
  perf-<metric>-<key>-<run>.json   perfwatch triage journalCursor
  restart records                  journalCursor + auditBundle pointer
  event-ring entries               attach_events() / the live ring joins
                                   EventSink.history() at query time

Memory is bounded on every axis: objects (LRU-evicted, counted), entries
per object (first entry kept, middle dropped, counted), loop rows and
problems (oldest dropped). The live LineageRing shares the store and adds
a lock + overhead meter: it is fed on the control-loop thread from dicts
the loop already computed — zero extra device dispatches by construction.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import OrderedDict

from kubernetes_autoscaler_tpu_torch.replay import journal as rj

_CHAIN_FILE = re.compile(r"^journal-\d{6}\.jsonl$")
_AUDIT_FILE = re.compile(r"^audit-\d{6}-.*\.json$")
_FLIGHT_FILE = re.compile(r"^flight-.*\.trace\.json$")
_PERF_FILE = re.compile(r"^perf-.*\.json$")

_ROWS_HELP = "Lineage entries currently indexed (live ring)"
_BYTES_HELP = "Approximate lineage index bytes held (live ring)"
_LAG_HELP = "Loops between the journal cursor and the lineage head"
_QUERIES_HELP = "Lineage queries served, by surface"
_OVERHEAD_HELP = "Wall seconds spent feeding the lineage ring"

# event-ring kinds → lineage object kinds (events.py taxonomy)
EVENT_OBJECT_KIND = {"NoScaleUp": "pod-group", "NoScaleDown": "node"}


def entries_from_outputs(loop: int, outputs: dict
                         ) -> list[tuple[tuple[str, str], dict]]:
    """One journaled loop's `outputs` → [((kind, name), entry)]. Pure dict
    work over collect_outputs' shape — shared verbatim by the offline
    index and the live ring, so `why` answers match either way."""
    out: list[tuple[tuple[str, str], dict]] = []
    reasons = outputs.get("reasons") or {}
    for g in reasons.get("groups", ()):
        name = g.get("exemplarPod") or f"row-{g.get('group')}"
        out.append((("pod-group", name), {
            "loop": loop, "event": "refused",
            "reason": g.get("reason", ""),
            "constraints": dict(g.get("constraints") or {}),
            "pods": int(g.get("pods", 0)),
            "row": int(g.get("group", -1)),
        }))
    su = outputs.get("scaleUp")
    if su:
        best = su.get("best") or {}
        for gid, delta in (su.get("increases") or {}).items():
            e = {"loop": loop, "event": "scale-up", "delta": int(delta),
                 "won": gid == best.get("group")}
            if e["won"]:
                e["pods"] = best.get("pods")
                e["waste"] = best.get("waste")
                e["price"] = best.get("price")
            out.append((("nodegroup", gid), e))
        for gid, err in (su.get("errors") or {}).items():
            out.append((("nodegroup", gid),
                        {"loop": loop, "event": "scale-up-error",
                         "error": str(err)}))
    for n, r in (reasons.get("unremovable") or {}).items():
        out.append((("node", n),
                    {"loop": loop, "event": "unremovable", "reason": r}))
    for n, d in (reasons.get("drainFail") or {}).items():
        out.append((("node", n),
                    {"loop": loop, "event": "drain-fail", "detail": d}))
    drain = outputs.get("drain") or {}
    for n in drain.get("unneeded", ()):
        out.append((("node", n), {"loop": loop, "event": "unneeded"}))
    for n in drain.get("deleted", ()):
        out.append((("node", n),
                    {"loop": loop, "event": "scale-down-deleted"}))
    return out


def _loop_row(loop: int, digest: str, now: float, outputs: dict,
              annotations: dict | None) -> dict:
    verdict = outputs.get("verdict") or {}
    su = outputs.get("scaleUp") or {}
    best = su.get("best") or {}
    reasons = outputs.get("reasons") or {}
    drain = outputs.get("drain") or {}
    sched = 0
    try:
        sched = int(rj.decode_verdict_plane(verdict).sum())
    except (ValueError, TypeError):
        pass
    row = {
        "loop": loop, "digest": digest, "now": now,
        "pending": int(verdict.get("pending", 0)),
        "scheduled": sched,
        "refused": len(reasons.get("groups") or ()),
        "scaleUp": ({"won": best.get("group", ""),
                     "increases": dict(su.get("increases") or {})}
                    if su.get("scaledUp") else None),
        "unneeded": len(drain.get("unneeded") or ()),
        "deleted": len(drain.get("deleted") or ()),
        "artifacts": [],
    }
    if outputs.get("aborted"):
        row["aborted"] = outputs["aborted"]
    if annotations:
        row["annotations"] = dict(annotations)
    return row


class _LineageStore:
    """The bounded store both the offline index and the live ring share.
    Not thread-safe here — LineageRing adds the lock."""

    def __init__(self, max_objects: int = 4096, per_object: int = 64,
                 max_loops: int = 1024, max_problems: int = 64):
        self.max_objects = max(int(max_objects), 1)
        self.per_object = max(int(per_object), 2)
        self.max_loops = max(int(max_loops), 1)
        self.max_problems = max(int(max_problems), 1)
        # (kind, name) -> {"entries": [..], "dropped": n, "firstLoop",
        #                  "lastLoop"}; OrderedDict as LRU (recently
        #                  touched last)
        self.objects: OrderedDict[tuple[str, str], dict] = OrderedDict()
        self.loops: OrderedDict[int, dict] = OrderedDict()
        self.problems: list[dict] = []
        # derived backend transitions ({"loop","from","to","cause"})
        self.transitions: list[dict] = []
        self.evicted_objects = 0
        self.dropped_entries = 0
        self.records = 0
        self.entries = 0
        self.bytes = 0
        self.run_head = ""
        self.first_loop: int | None = None
        self.last_loop: int | None = None
        # refusal state for resolved-transition detection
        self._open_refusals: dict[tuple[str, str], int] = {}
        self._last_scale_up: dict | None = None

    # ---- ingestion -------------------------------------------------------

    def _append(self, key: tuple[str, str], entry: dict) -> None:
        obj = self.objects.get(key)
        if obj is None:
            obj = {"entries": [], "dropped": 0,
                   "firstLoop": entry["loop"], "lastLoop": entry["loop"]}
            self.objects[key] = obj
            while len(self.objects) > self.max_objects:
                self.objects.popitem(last=False)
                self.evicted_objects += 1
        obj["lastLoop"] = entry["loop"]
        obj["entries"].append(entry)
        self.entries += 1
        self.bytes += len(json.dumps(entry, separators=(",", ":")))
        if len(obj["entries"]) > self.per_object:
            # keep the FIRST entry (the chain's origin — "pending since
            # loop 12" needs it) and the newest tail; drop from the middle
            dropped = obj["entries"].pop(1)
            obj["dropped"] += 1
            self.dropped_entries += 1
            self.bytes -= len(json.dumps(dropped, separators=(",", ":")))
        self.objects.move_to_end(key)

    def _problem(self, kind: str, **detail) -> None:
        if len(self.problems) >= self.max_problems:
            self.problems.pop(0)
        self.problems.append({"kind": kind, **detail})

    def ingest_outputs(self, loop: int, digest: str, now: float,
                       outputs: dict, annotations: dict | None = None
                       ) -> None:
        """One loop's decision surface into the store (shared by record
        replay below and the live ring's observe())."""
        self.records += 1
        if self.first_loop is None:
            self.first_loop = loop
        self.last_loop = loop
        row = _loop_row(loop, digest, now, outputs, annotations)
        self.loops[loop] = row
        while len(self.loops) > self.max_loops:
            self.loops.popitem(last=False)
        pairs = entries_from_outputs(loop, outputs)
        for key, entry in pairs:
            self._append(key, entry)
        if row["scaleUp"] is not None:
            self._last_scale_up = {"loop": loop, **row["scaleUp"]}
        # resolved transitions: a pod-group refused last loop and absent
        # from this loop's refusals either scheduled or left the pending
        # set — if a scale-up landed since the refusal opened, name it as
        # the cause (the "refused → scale-up won → bound" causal chain)
        if outputs.get("ran"):
            refused_now = {k for k, e in pairs
                           if k[0] == "pod-group" and e["event"] == "refused"}
            for key, since in list(self._open_refusals.items()):
                if key in refused_now:
                    continue
                del self._open_refusals[key]
                entry = {"loop": loop, "event": "resolved",
                         "pendingSince": since}
                su = self._last_scale_up
                if su is not None and su["loop"] >= since:
                    entry["afterScaleUp"] = {"loop": su["loop"],
                                             "won": su["won"]}
                self._append(key, entry)
            for key in refused_now:
                self._open_refusals.setdefault(key, loop)

    def attach_artifact(self, loop: int, art: dict,
                        objects: list[tuple[str, str]] | None = None
                        ) -> None:
        """Stitch one cursor-resolved artifact onto its loop row (and any
        objects it names — e.g. the node in a drain divergence)."""
        row = self.loops.get(loop)
        if row is not None:
            row["artifacts"].append(art)
        for key in objects or ():
            self._append(key, {"loop": loop,
                               "event": f"artifact:{art['kind']}",
                               "path": art.get("path", ""),
                               **({"detail": art["detail"]}
                                  if art.get("detail") else {})})

    def attach_events(self, events: list[dict]) -> None:
        """Join event-ring entries (events.py Event.to_dict shape) onto
        their objects. Loop attribution uses the object's last known loop
        (events carry wall time, not loop indices)."""
        for ev in events:
            kind = EVENT_OBJECT_KIND.get(ev.get("kind", ""), "object")
            key = (kind, ev.get("object", ""))
            obj = self.objects.get(key)
            loop = obj["lastLoop"] if obj else (self.last_loop or 0)
            self._append(key, {
                "loop": loop, "event": "event",
                "eventKind": ev.get("kind", ""),
                "reason": ev.get("reason", ""),
                "count": int(ev.get("count", 1)),
                **({"message": ev["message"]} if ev.get("message") else {}),
            })

    def note_transition(self, loop: int, frm: str, to: str,
                        cause: str = "") -> None:
        self.transitions.append({"loop": loop, "from": frm, "to": to,
                                 **({"cause": cause} if cause else {})})
        if len(self.transitions) > self.max_problems:
            self.transitions.pop(0)

    # ---- queries ---------------------------------------------------------

    def why(self, kind: str, name: str) -> dict:
        key = (kind, name)
        obj = self.objects.get(key)
        loops_of = set()
        entries: list[dict] = []
        dropped = 0
        if obj is not None:
            entries = list(obj["entries"])
            dropped = obj["dropped"]
            loops_of = {e["loop"] for e in entries}
        arts = [dict(a, loop=lp) for lp, row in self.loops.items()
                if lp in loops_of for a in row["artifacts"]]
        return {
            "object": f"{kind}/{name}", "found": obj is not None,
            "run": self.run_head,
            "loops": ([obj["firstLoop"], obj["lastLoop"]]
                      if obj is not None else None),
            "entries": entries, "droppedEntries": dropped,
            "artifacts": arts,
            "transitions": list(self.transitions),
        }

    def timeline(self, lo: int | None = None, hi: int | None = None
                 ) -> list[dict]:
        return [row for lp, row in self.loops.items()
                if (lo is None or lp >= lo) and (hi is None or lp <= hi)]

    def diff(self, loop: int) -> dict:
        """Object-level delta between loop-1 and loop: verdicts that
        appeared, changed or resolved across the boundary."""
        cur = {key: e for key, obj in self.objects.items()
               for e in obj["entries"] if e["loop"] == loop}
        prev = {key: e for key, obj in self.objects.items()
                for e in obj["entries"] if e["loop"] == loop - 1}
        appeared = [{"object": "/".join(k), **cur[k]}
                    for k in sorted(set(cur) - set(prev))]
        gone = [{"object": "/".join(k), "was": prev[k]}
                for k in sorted(set(prev) - set(cur))]
        changed = [{"object": "/".join(k), "was": prev[k], "now": cur[k]}
                   for k in sorted(set(cur) & set(prev))
                   if (prev[k].get("event"), prev[k].get("reason")) !=
                      (cur[k].get("event"), cur[k].get("reason"))]
        row, prow = self.loops.get(loop), self.loops.get(loop - 1)
        return {
            "loop": loop, "run": self.run_head,
            "appeared": appeared, "resolved": gone, "changed": changed,
            "pendingDelta": ((row["pending"] - prow["pending"])
                             if row and prow else None),
            "scaleUp": row["scaleUp"] if row else None,
            "artifacts": row["artifacts"] if row else [],
        }

    def summary(self, limit: int = 32) -> dict:
        """Compact per-object digest (newest-touched first) for /whyz and
        /snapshotz payloads."""
        objs = []
        for key, obj in list(self.objects.items())[::-1][:limit]:
            last = obj["entries"][-1] if obj["entries"] else {}
            objs.append({"object": "/".join(key),
                         "loops": [obj["firstLoop"], obj["lastLoop"]],
                         "entries": len(obj["entries"]),
                         "dropped": obj["dropped"],
                         "last": last})
        return {"run": self.run_head,
                "loops": ([self.first_loop, self.last_loop]
                          if self.last_loop is not None else None),
                "objects": objs, "transitions": list(self.transitions),
                "stats": self.stats()}

    def stats(self) -> dict:
        return {"objects": len(self.objects), "entries": self.entries,
                "records": self.records, "bytes": self.bytes,
                "evictedObjects": self.evicted_objects,
                "droppedEntries": self.dropped_entries,
                "problems": len(self.problems)}


class LineageIndex(_LineageStore):
    """Incremental index over a journal DIRECTORY plus any artifact dirs.

    `run` selects which chain to index when the dir holds several runs:
    None follows the LATEST run (a new chain head resets the index — the
    follow-mode contract: tailing a dir across an autoscaler restart
    follows the new process); a digest prefix pins one run. refresh()
    reads only appended bytes; call it again to tail."""

    def __init__(self, journal_dir: str, run: str | None = None,
                 artifact_dirs: list[str] | None = None,
                 verify_seals: bool = True, **bounds):
        super().__init__(**bounds)
        self.journal_dir = journal_dir
        self.run_select = run or None
        self.verify_seals = verify_seals
        self._extra_dirs = list(artifact_dirs or ())
        self.meta: dict = {}
        self._last_meta: dict = {}
        self._positions: dict[str, int] = {}
        self._parsed_artifacts: dict[str, tuple[float, int]] = {}
        self._selected = run is None        # pre-chain: latest-run mode
        self._seen_any = False
        self._last_digest = ""
        self.runs: list[dict] = []          # every chain head seen
        self.newest_loop_seen: int | None = None
        self.refresh()

    # ---- journal scan ----------------------------------------------------

    def _chain_files(self) -> list[str]:
        if not os.path.isdir(self.journal_dir):
            return []
        return sorted(os.path.join(self.journal_dir, f)
                      for f in os.listdir(self.journal_dir)
                      if _CHAIN_FILE.match(f))

    def refresh(self) -> int:
        """Ingest appended records + newly resolvable artifacts; returns
        the number of NEW records ingested into the selected run."""
        new = 0
        files = self._chain_files()
        for i, fp in enumerate(files):
            new += self._scan_file(fp, is_last=(i == len(files) - 1))
        self._scan_artifacts()
        return new

    def _scan_file(self, fp: str, is_last: bool) -> int:
        try:
            size = os.path.getsize(fp)
        except OSError:
            return 0
        pos = self._positions.get(fp, 0)
        if size <= pos:
            return 0
        try:
            with open(fp, "rb") as f:
                f.seek(pos)
                chunk = f.read(size - pos)
        except OSError:
            return 0
        # complete lines only: a torn tail (writer mid-append, or a kill
        # mid-line) stays unconsumed — the next refresh() retries it, and
        # a tail that never completes on the FINAL file is the classic
        # torn-tail problem load_journal surfaces
        end = chunk.rfind(b"\n")
        if end < 0:
            if not is_last:
                self._problem("torn-tail", file=fp)
                self._positions[fp] = size
            return 0
        self._positions[fp] = pos + end + 1
        new = 0
        for raw in chunk[:end].split(b"\n"):
            raw = raw.strip()
            if not raw:
                continue
            try:
                rec = json.loads(raw)
            except json.JSONDecodeError:
                self._problem("bad-line", file=fp)
                continue
            if rec.get("kind") == "meta":
                self._last_meta = rec
                continue
            new += self._ingest_record(rec, fp)
        return new

    def _ingest_record(self, rec: dict, fp: str) -> int:
        if self.verify_seals:
            sealed = rec.get("digest", "")
            if rj.seal_record(dict(rec))["digest"] != sealed:
                self._problem("bad-seal", file=fp, loop=rec.get("loop"))
                return 0
        loop = rec.get("loop")
        if not isinstance(loop, int):
            self._problem("bad-line", file=fp)
            return 0
        self.newest_loop_seen = loop if self.newest_loop_seen is None \
            else max(self.newest_loop_seen, loop)
        boundary = (rec.get("kind") == "snapshot"
                    and rec.get("parent") == "") or not self._seen_any
        self._seen_any = True
        if boundary:
            head = rec.get("digest", "")
            self.runs.append({"head": head, "firstLoop": loop, "records": 0})
            if self.run_select is None:
                # latest-run mode: a fresh chain resets the store (tailing
                # across a restart follows the new process, never splices
                # two runs' cross-loop state into one story)
                if self.run_head:
                    self._reset_store()
                self._selected = True
                self.run_head = head
            else:
                self._selected = head.startswith(self.run_select)
                if self._selected:
                    self.run_head = head
        if self.runs:
            self.runs[-1]["records"] += 1
            self.runs[-1]["lastLoop"] = loop
        if not self._selected:
            return 0
        if self._last_digest and rec.get("parent") != self._last_digest \
                and not boundary:
            self._problem("chain-break", file=fp, loop=loop)
        self._last_digest = rec.get("digest", "")
        if not self.meta and self._last_meta:
            self.meta = self._last_meta
        self.ingest_outputs(
            loop, rec.get("digest", ""), float(rec.get("now", 0.0)),
            rec.get("outputs") or {},
            {k: rec[k] for k in ("fusedMode", "loopDeviceRoundTrips",
                                 "speculation") if k in rec})
        return 1

    def _reset_store(self) -> None:
        keep = (self.max_objects, self.per_object, self.max_loops,
                self.max_problems)
        runs, seen = self.runs, self._seen_any
        _LineageStore.__init__(self, *keep)
        self.runs, self._seen_any = runs, seen
        self.meta = {}           # the new run's meta line governs now
        self._last_digest = ""
        self._parsed_artifacts.clear()

    # ---- artifact stitching ---------------------------------------------

    def artifact_dirs(self) -> list[str]:
        """Journal dir + every evidence dir the recorded options name —
        the meta line carries the full AutoscalingOptions, so the index
        discovers the flight/audit/triage dirs without being told."""
        dirs = [self.journal_dir, *self._extra_dirs]
        opts = (self.meta or self._last_meta).get("options") or {}
        for k in ("flight_recorder_dir", "shadow_audit_dir",
                  "device_profile_dir"):
            if opts.get(k):
                dirs.append(opts[k])
        if opts.get("restart_state_path"):
            dirs.append(os.path.dirname(opts["restart_state_path"]) or ".")
        out, seen = [], set()
        for d in dirs:
            d = os.path.abspath(d)
            if d not in seen and os.path.isdir(d):
                seen.add(d)
                out.append(d)
        return out

    def _digest_loops(self) -> dict[str, int]:
        return {row["digest"]: lp for lp, row in self.loops.items()
                if row.get("digest")}

    def _scan_artifacts(self) -> None:
        by_digest = self._digest_loops()
        restart_path = ((self.meta or self._last_meta).get("options")
                        or {}).get("restart_state_path", "")
        for d in self.artifact_dirs():
            try:
                names = sorted(os.listdir(d))
            except OSError:
                continue
            for name in names:
                path = os.path.join(d, name)
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                tag = (st.st_mtime, st.st_size)
                if self._parsed_artifacts.get(path) == tag:
                    continue
                self._parsed_artifacts[path] = tag
                try:
                    if _AUDIT_FILE.match(name):
                        self._stitch_audit(path, by_digest)
                    elif _FLIGHT_FILE.match(name):
                        self._stitch_flight(path, by_digest)
                    elif _PERF_FILE.match(name):
                        self._stitch_perf(path, by_digest)
                    elif path == os.path.abspath(restart_path) \
                            or name == os.path.basename(restart_path or "§"):
                        self._stitch_restart(path, by_digest)
                except (OSError, json.JSONDecodeError, KeyError,
                        TypeError, ValueError):
                    self._problem("bad-artifact", file=path)

    def _cursor_loop(self, cursor, by_digest: dict[str, int]) -> int | None:
        """A [loop, digest] cursor resolves only against the SELECTED
        run's records — another run's artifacts must not stitch here."""
        if not cursor or len(cursor) != 2:
            return None
        loop = by_digest.get(cursor[1])
        return loop if loop == cursor[0] else None

    def _stitch_audit(self, path: str, by_digest: dict[str, int]) -> None:
        with open(path) as f:
            b = json.load(f)
        if b.get("kind") != "shadow-audit-divergence":
            return
        loop = self._cursor_loop(b.get("journalCursor"), by_digest)
        if loop is None:
            return
        surfaces = sorted({d.get("surface", "") for d in
                           b.get("divergences") or ()})
        art = {"kind": "audit-bundle", "path": path,
               "traceId": b.get("traceId", ""),
               "persistent": bool(b.get("persistent")),
               "detail": ",".join(surfaces)}
        # objects the divergence names outright (drain divergences carry
        # the candidate node)
        named = sorted({("node", d["node"]) for d in
                        b.get("divergences") or () if d.get("node")})
        self.attach_artifact(loop, art, objects=named)
        # derived ladder transitions: a bundle IS the suspect transition's
        # evidence; a persistent bundle is the degrade's
        self.note_transition(loop, "healthy", "suspect",
                             cause="audit_divergence")
        if art["persistent"]:
            self.note_transition(loop, "suspect", "degraded",
                                 cause="audit_divergence")

    def _stitch_flight(self, path: str, by_digest: dict[str, int]) -> None:
        with open(path) as f:
            doc = json.load(f)
        other = doc.get("otherData") or {}
        reasons = other.get("dump_reasons") or other.get("retain_reasons") \
            or {}
        seen: set[tuple[int, str]] = set()
        for ev in doc.get("traceEvents") or ():
            args = ev.get("args") or {}
            dg, tid = args.get("journal_digest"), args.get("trace_id", "")
            if not dg:
                continue
            loop = by_digest.get(dg)
            if loop is None or (loop, tid) in seen:
                continue
            seen.add((loop, tid))
            self.attach_artifact(loop, {
                "kind": "flight-dump", "path": path, "traceId": tid,
                "detail": reasons.get(tid, "")})

    def _stitch_perf(self, path: str, by_digest: dict[str, int]) -> None:
        with open(path) as f:
            b = json.load(f)
        if b.get("kind") != "perf-regression":
            return
        loop = self._cursor_loop(b.get("journalCursor"), by_digest)
        art = {"kind": "perf-triage", "path": path,
               "traceId": b.get("traceId", ""),
               "detail": b.get("metric", "")}
        if loop is not None:
            self.attach_artifact(loop, art)
        elif self.last_loop is not None:
            # a triage bundle without a resolvable cursor still belongs to
            # the evidence story — pinned to the newest loop, flagged
            self.attach_artifact(self.last_loop,
                                 dict(art, cursorResolved=False))

    def _stitch_restart(self, path: str, by_digest: dict[str, int]) -> None:
        with open(path) as f:
            b = json.load(f)
        loop = self._cursor_loop(b.get("journalCursor"), by_digest)
        if loop is None:
            return
        self.attach_artifact(loop, {
            "kind": "restart-record", "path": path,
            "detail": (f"auditBundle={b['auditBundle']}"
                       if b.get("auditBundle") else "")})

    def stats(self) -> dict:
        lag = 0
        if self.newest_loop_seen is not None and self.last_loop is not None:
            lag = max(self.newest_loop_seen - self.last_loop, 0)
        return {**super().stats(), "lagLoops": lag,
                "runs": len(self.runs)}


class LineageRing(_LineageStore):
    """The live, in-process lineage surface StaticAutoscaler feeds once
    per RunOnce — bounded like the flight recorder, locked because /whyz
    and gRPC handlers read it off-thread, metered because it rides the
    control loop (overhead is CI-bounded like the shadow audit's). The
    feed is pure host dict work over outputs the loop already computed:
    it can add ZERO device dispatches by construction."""

    def __init__(self, objects: int = 512, per_object: int = 32,
                 loops: int = 128, registry=None, event_sink=None):
        super().__init__(max_objects=objects, per_object=per_object,
                         max_loops=loops)
        self.registry = registry
        self.event_sink = event_sink
        self._lock = threading.Lock()
        self._loop_seq = 0
        self._backend_state = "healthy"
        self.overhead_ns = 0

    def observe(self, *, loop: int | None, digest: str, now: float,
                outputs: dict, annotations: dict | None = None,
                audit: dict | None = None,
                backend_state: str | None = None) -> None:
        t0 = time.perf_counter_ns()
        with self._lock:
            k = loop if loop is not None else self._loop_seq
            self._loop_seq = k + 1
            if not self.run_head and digest:
                self.run_head = digest     # first cursor = this run's head
            self.ingest_outputs(k, digest, now, outputs, annotations)
            if audit is not None:
                self.attach_artifact(k, {
                    "kind": "audit-bundle",
                    "path": audit.get("bundlePath", ""),
                    "traceId": audit.get("traceId", ""),
                    "persistent": bool(audit.get("persistent")),
                    "detail": ",".join(audit.get("surfaces") or ())})
            if backend_state and backend_state != self._backend_state:
                self.note_transition(k, self._backend_state, backend_state)
                self._backend_state = backend_state
        dt = time.perf_counter_ns() - t0
        self.overhead_ns += dt
        if self.registry is not None:
            self.registry.counter("lineage_overhead_seconds_total",
                                  help=_OVERHEAD_HELP).inc(dt / 1e9)
            self.registry.gauge("lineage_index_rows",
                                help=_ROWS_HELP).set(float(self.entries))
            self.registry.gauge("lineage_index_bytes",
                                help=_BYTES_HELP).set(float(self.bytes))
            # the live ring observes the loop that just committed — a
            # nonzero lag means observes were skipped (aborted loops)
            lag = 0 if loop is None else max(loop - (self.last_loop or 0), 0)
            self.registry.gauge("lineage_index_lag_loops",
                                help=_LAG_HELP).set(float(lag))

    def _count_query(self, surface: str) -> None:
        if self.registry is not None:
            self.registry.counter("lineage_queries_total",
                                  help=_QUERIES_HELP).inc(surface=surface)

    def why(self, kind: str, name: str, surface: str = "api") -> dict:
        self._count_query(surface)
        with self._lock:
            out = super().why(kind, name)
        # join the event ring's bounded per-object history at QUERY time —
        # zero per-loop cost on the control loop
        sink = self.event_sink
        if sink is not None and hasattr(sink, "history"):
            ev_kind = {v: k for k, v in EVENT_OBJECT_KIND.items()}.get(kind)
            evs = sink.history(ev_kind, name) if ev_kind else []
            if evs:
                out["events"] = evs
        return out

    def snapshot_summary(self, limit: int = 32,
                         surface: str = "snapshotz") -> dict:
        self._count_query(surface)
        with self._lock:
            return self.summary(limit)

    def timeline(self, lo=None, hi=None, surface: str = "api"):
        self._count_query(surface)
        with self._lock:
            return super().timeline(lo, hi)

    def diff(self, loop: int, surface: str = "api") -> dict:
        self._count_query(surface)
        with self._lock:
            return super().diff(loop)

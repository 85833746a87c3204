"""Replay harness: reconstruct journaled worlds and re-execute the loops.

Three stages, each checkable on its own:

  load_journal()       parse + INTEGRITY-check the record stream (every
                       record's seal recomputed; parent-chain breaks
                       collected, not fatal — a rotated journal legally
                       starts mid-history at a snapshot record).
  reconstruct_worlds() apply snapshot+deltas forward, verifying each
                       record's `worldDigest` against the reconstruction
                       (the round-trip contract the writer enforced at
                       record time, re-proven at read time).
  replay_journal()     drive a fresh StaticAutoscaler through the recorded
                       loops — recorded options, recorded `now`s, recorded
                       worlds presented with the recorded object-churn
                       pattern (only changed objects are replaced, so the
                       incremental encoder sees the same delta sequence the
                       recorder saw) — and compare every output surface's
                       digest. The drift report localizes: per-group
                       verdict byte diffs, and a reason-plane pass (uint16
                       refusal bits per pod-group × node, ops/predicates.
                       reason_mask) naming exactly which bits flipped.

Cross-device divergence mode: record on one device, replay on the other
(`--device cpu|cuda`). Digest equality then proves the CUDA path (the
hand-written pack kernel) and the CPU's plain PyTorch versions compute
identical verdicts — the correctness oracle docs/REPLAY.md describes.
"""

from __future__ import annotations

import json
import os

from kubernetes_autoscaler_tpu_torch.replay import journal as rj


class JournalError(ValueError):
    """Structural journal failure (unparseable, bad seal, bad round-trip)."""


def _journal_files(path: str) -> list[str]:
    if os.path.isfile(path):
        return [path]
    if not os.path.isdir(path):
        raise JournalError(f"no journal at {path!r}")
    files = sorted(
        os.path.join(path, f) for f in os.listdir(path)
        if f.startswith("journal-") and f.endswith(".jsonl"))
    if not files:
        raise JournalError(f"no journal-*.jsonl files under {path!r}")
    return files


def load_journal(path: str, run: str | None = None
                 ) -> tuple[dict, list[dict], list[dict]]:
    """→ (meta, records, problems). Seals are recomputed for every record;
    a mismatch is fatal (the file is corrupt, not merely drifted). Parent
    chain breaks (rotation pruning) are collected as problems.

    A journal DIRECTORY may hold several RUNS: each autoscaler process
    starts a fresh chain (first record: a snapshot with parent="" at loop
    0) and never deletes a predecessor's files at startup — they are
    evidence (only the rotation size bound may later prune them,
    oldest-first, with drop accounting). Stitching runs into one stream
    would replay run 2
    under run 1's accumulated cross-loop state (timers, backoffs) the
    recorder never had, reporting spurious drift — so only ONE run is
    loaded. `run` selects it by chain head: a digest prefix of any run's
    FIRST record (the heads the `previous-runs` problem lists); None keeps
    the historical default, the LAST run. The other runs are surfaced as a
    `previous-runs` problem either way (count/loops plus a per-run `runs`
    list of head digests and loop ranges), and `meta` is the meta line
    governing the loaded run."""
    runs: list[tuple[dict, list[dict], list[dict]]] = []
    meta: dict = {}
    records: list[dict] = []
    problems: list[dict] = []
    last_meta: dict = {}
    files = _journal_files(path)
    for fp in files:
        with open(fp) as f:
            lines = [(ln, line.strip()) for ln, line in enumerate(f)
                     if line.strip()]
        for i, (ln, line) in enumerate(lines):
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                if fp == files[-1] and i == len(lines) - 1:
                    # a torn TRAILING line (writer killed mid-append /
                    # ENOSPC on an old build): the records before it are
                    # intact evidence — surface, don't destroy
                    problems.append({"kind": "torn-tail", "file": fp,
                                     "line": ln + 1})
                    break
                raise JournalError(f"{fp}:{ln + 1}: not JSON ({e})")
            if rec.get("kind") == "meta":
                last_meta = rec
                if records and rec.get("config") != meta.get("config"):
                    problems.append({"kind": "config-change",
                                     "file": fp, "line": ln + 1})
                continue
            sealed = rec.get("digest", "")
            if rj.seal_record(dict(rec))["digest"] != sealed:
                raise JournalError(
                    f"{fp}:{ln + 1}: record seal mismatch (loop "
                    f"{rec.get('loop')}) — journal is corrupt")
            if records and rec.get("kind") == "snapshot" \
                    and rec.get("parent") == "":
                # a fresh process re-journaled into the same dir: run
                # boundary (rotation keeps the parent chain; only a new
                # writer starts from parent="")
                runs.append((meta, records, problems))
                meta, records, problems = {}, [], []
            if not records:
                meta = last_meta
            if records and rec.get("kind") == "delta" \
                    and rec.get("parent") != records[-1]["digest"]:
                raise JournalError(
                    f"{fp}:{ln + 1}: delta record's parent does not "
                    f"match the previous record")
            if records and rec.get("kind") == "snapshot" \
                    and rec.get("parent") != records[-1]["digest"]:
                # legal after rotation pruned the ancestor files
                problems.append({"kind": "chain-break", "file": fp,
                                 "loop": rec.get("loop")})
            records.append(rec)
    if not records:
        raise JournalError(f"journal at {path!r} holds no records")
    runs.append((meta, records, problems))
    if run is not None:
        matches = [r for r in runs
                   if r[1] and r[1][0].get("digest", "").startswith(run)]
        if not matches:
            heads = [r[1][0].get("digest", "")[:16] for r in runs if r[1]]
            raise JournalError(
                f"no run with chain head {run!r} in {path!r} "
                f"(heads: {', '.join(heads) or 'none'})")
        if len(matches) > 1:
            raise JournalError(
                f"chain-head prefix {run!r} is ambiguous in {path!r}")
        meta, records, problems = matches[0]
    else:
        meta, records, problems = runs[-1]
    if records[0].get("kind") != "snapshot":
        raise JournalError("journal starts with a delta record (its "
                           "snapshot base was pruned past keep_files?)")
    others = [r for r in runs if r[1] is not records]
    if others:
        problems.append({
            "kind": "previous-runs", "count": len(others),
            "loops": sum(len(r[1]) for r in others),
            # selectable chain heads for load_journal(run=...) / the
            # lineage CLI's --run
            "runs": [{"head": r[1][0].get("digest", ""),
                      "firstLoop": r[1][0].get("loop"),
                      "lastLoop": r[1][-1].get("loop"),
                      "records": len(r[1])} for r in others],
        })
    return meta, records, problems


def reconstruct_worlds(records: list[dict]):
    """Yield (record, world_index) applying snapshot+deltas forward, each
    step digest-verified against the record's `worldDigest`."""
    idx = None
    for rec in records:
        if rec["kind"] == "snapshot":
            idx = rj.index_from_snapshot(rec["world"])
        else:
            if idx is None:
                raise JournalError(f"loop {rec['loop']}: delta without a "
                                   f"preceding snapshot")
            idx = rj.apply_world_delta(idx, rec.get("delta", {}))
        got = idx.digest()
        if got != rec["worldDigest"]:
            raise JournalError(
                f"loop {rec['loop']}: reconstructed world digest {got} != "
                f"recorded {rec['worldDigest']} (round-trip check failed)")
        yield rec, idx


def options_from_meta(meta: dict, neutralize: bool = True):
    """Rebuild the recorded AutoscalingOptions (unknown/renamed fields are
    dropped — forward compatibility over strictness).

    With `neutralize` (the replay path), side-effecting fields are cleared:
    no journaling of the replay itself, no flight-recorder dumps into the
    RECORDER's evidence directory, no SLO-breach accounting from a slower
    replay machine. The report's config fingerprint is computed with
    neutralize=False so a faithful replay matches the recorded one."""
    import dataclasses

    from kubernetes_autoscaler_tpu_torch.config.options import (
        AutoscalingOptions,
        NodeGroupDefaults,
    )

    d = dict(meta.get("options") or {})
    ngd = d.pop("node_group_defaults", None)
    known = {f.name for f in dataclasses.fields(AutoscalingOptions)}
    opts = AutoscalingOptions(**{k: v for k, v in d.items() if k in known})
    if isinstance(ngd, dict):
        kn = {f.name for f in dataclasses.fields(NodeGroupDefaults)}
        opts.node_group_defaults = NodeGroupDefaults(
            **{k: v for k, v in ngd.items() if k in kn})
    if neutralize:
        opts.journal_dir = ""
        opts.flight_recorder_dir = ""
        opts.loop_wallclock_budget_s = 0.0
        # the replay's shadow audit re-runs the recorded sampling (same
        # cursor seeds via parent_override) but must not write divergence
        # bundles into the RECORDER's evidence directory
        opts.shadow_audit_dir = ""
    return opts


class ReplaySource:
    """ClusterDataSource over reconstructed worlds. Object identity follows
    the recorded churn: only added/modified entries get fresh objects, so
    the incremental encoder's replace-on-update contract sees the same
    delta sequence the recorder's source produced."""

    def __init__(self):
        self._nodes: dict[str, tuple[str, object]] = {}   # name -> (canon, Node)
        self._pods: dict[str, tuple[str, object]] = {}    # ns/name -> (canon, Pod)

    def set_world(self, idx: "rj._WorldIndex") -> None:
        self._nodes = self._sync(self._nodes, idx.nodes, rj.node_from_dict)
        self._pods = self._sync(self._pods, idx.pods, rj.pod_from_dict)

    @staticmethod
    def _sync(store: dict, canon_map: dict[str, str], build):
        out = {}
        for key, canon in canon_map.items():
            held = store.get(key)
            if held is not None and held[0] == canon:
                out[key] = held
            else:
                out[key] = (canon, build(json.loads(canon)))
        return out

    def list_nodes(self):
        return [obj for _, obj in self._nodes.values()]

    def list_pods(self):
        return [obj for _, obj in self._pods.values()]

    # EvictionSink: actuation during replay must not touch anything real
    def evict(self, pod, node, grace_period_s=None) -> None:
        pass


def _sync_provider(provider, groups: list[dict], template_cache: dict) -> None:
    """Force the in-memory provider to the recorded node-group states
    (sizes, template, price, node membership). Reaches into the test
    provider's internals on purpose — replay owns this provider outright."""
    seen = set()
    for gs in groups:
        canon = rj.canonical(gs["template"])
        cached = template_cache.get(gs["id"])
        if cached is None or cached[0] != canon:
            cached = (canon, rj.node_from_dict(gs["template"]))
            template_cache[gs["id"]] = cached
        tmpl = cached[1]
        g = provider._groups.get(gs["id"])
        if g is None:
            g = provider.add_node_group(
                gs["id"], tmpl, min_size=gs["min"], max_size=gs["max"],
                target=gs["target"], price_per_node=gs["price"])
        else:
            g._min, g._max = gs["min"], gs["max"]
            g._target = gs["target"]
            g._template = tmpl
            g.price_per_node = gs["price"]
            g._instances = []
        seen.add(gs["id"])
    for gid in list(provider._groups):
        if gid not in seen:
            del provider._groups[gid]
    provider._node_to_group = {
        name: gs["id"] for gs in groups for name in gs.get("members", [])}


def _reason_plane_diff(rec: dict, world: "rj._WorldIndex",
                       drifted_groups: set[int] | None = None,
                       device=None) -> list[dict]:
    """Reason-plane localization for a drifted loop: encode the record's
    world fresh and dispatch `reason_mask` — uint16 refusal bits per
    (pod-group × node). The recorded baseline per pair is derived from the
    recorded outputs (a group the recorder scheduled carried zero bits; a
    refused group carries its recorded constraint names), so each entry
    names the pod-group (exemplar pod), the node, and WHICH bits flipped."""
    from kubernetes_autoscaler_tpu_torch.models.encode import encode_cluster
    from kubernetes_autoscaler_tpu_torch.ops import predicates as preds
    from kubernetes_autoscaler_tpu_torch.ops.hostfetch import to_host

    snap = rj.snapshot_from_index(world)
    nodes = [rj.node_from_dict(d) for d in snap["nodes"]]
    pods = [rj.pod_from_dict(d) for d in snap["pods"]]
    enc = encode_cluster(nodes, pods, device=device)
    bits = to_host(preds.reason_mask(enc.nodes, enc.specs))
    counts = to_host(enc.specs.count)
    recorded = rec["outputs"]
    rec_sched = rj.decode_verdict_plane(recorded["verdict"])
    rec_reasons = {g["group"]: g for g in recorded["reasons"]["groups"]}
    out: list[dict] = []
    pending_rows = [gi for gi in range(len(enc.group_pods))
                    if counts[gi] > 0 or (drifted_groups and gi in drifted_groups)]
    for gi in pending_rows:
        if drifted_groups is not None and gi not in drifted_groups:
            continue
        exemplar = ""
        if gi < len(enc.group_pods) and enc.group_pods[gi]:
            exemplar = enc.pending_pods[enc.group_pods[gi][0]].name
        rec_row = rec_reasons.get(gi)
        rec_bits = set(rec_row["constraints"]) if rec_row else set()
        if gi < rec_sched.shape[0] and rec_sched[gi] > 0:
            rec_bits = set()          # the recorder scheduled this group
        for ni, name in enumerate(enc.node_names):
            names = set(preds.reason_bit_names(int(bits[gi, ni])))
            flipped = sorted(names ^ rec_bits)
            if not names and not flipped:
                continue
            out.append({"group": int(gi), "exemplarPod": exemplar,
                        "node": name,
                        "replayedBits": sorted(names),
                        "recordedBits": sorted(rec_bits),
                        "flipped": flipped})
    return out


def _verdict_diff(rec: dict, outputs: dict) -> list[dict]:
    a = rj.decode_verdict_plane(rec["outputs"]["verdict"])
    b = rj.decode_verdict_plane(outputs["verdict"])
    n = max(a.shape[0], b.shape[0])
    out = []
    for gi in range(n):
        ra = int(a[gi]) if gi < a.shape[0] else None
        rb = int(b[gi]) if gi < b.shape[0] else None
        if ra != rb:
            out.append({"group": gi, "recorded": ra, "replayed": rb})
    return out


def replay_journal(path: str, upto: int | None = None, diff: bool = False,
                   keep_autoscaler: bool = False,
                   options_override: dict | None = None,
                   device=None) -> dict:
    """Re-execute a journal; → drift report. `upto` stops after that loop
    index (earlier loops still replay — the autoscaler's cross-loop state
    is part of the recorded history). `diff=True` adds the reason-plane
    localization even for clean loops' drifted groups (drifted loops always
    get it). `options_override` force-sets option fields AFTER the recorded
    options are rebuilt — the fused-loop cross-oracle records with
    --fused-loop and replays with {"fused_loop": False} (or vice versa) to
    prove the two execution modes make bit-identical decisions
    (docs/FUSED_LOOP.md). `device` (None = CUDA, raising without a card)
    is where the replayed loop runs."""
    from kubernetes_autoscaler_tpu_torch.cloudprovider.test_provider import (
        TestCloudProvider,
    )
    from kubernetes_autoscaler_tpu_torch.core.static_autoscaler import (
        StaticAutoscaler,
    )

    meta, records, problems = load_journal(path)
    options = options_from_meta(meta)
    for k, v in (options_override or {}).items():
        setattr(options, k, v)
    provider = TestCloudProvider()
    src = ReplaySource()
    clock = {"now": 0.0}
    autoscaler = StaticAutoscaler(provider, src, options=options,
                                  eviction_sink=src,
                                  walltime=lambda: clock["now"],
                                  device=device)
    autoscaler.capture_verdicts = True
    template_cache: dict = {}
    drift_loops: list[int] = []
    loops: list[dict] = []
    for rec, world in reconstruct_worlds(records):
        if upto is not None and rec["loop"] > upto:
            break
        clock["now"] = rec["now"]
        if getattr(autoscaler, "shadow_auditor", None) is not None:
            # cursor-seeding contract (docs/REPLAY.md): the recorder
            # seeded loop k's sample with record k-1's digest; the record
            # carries exactly that as `parent`, so the replayed audit
            # draws the SAME cells without a live journal
            autoscaler.shadow_auditor.parent_override = rec.get(
                "parent", "")
        src.set_world(world)
        # groups-only parse: snapshot_from_index would json-parse every
        # node/pod canon per loop just to discard them (ReplaySource
        # already syncs those churn-only)
        _sync_provider(provider,
                       [json.loads(c) for c in world.groups.values()],
                       template_cache)
        status = autoscaler.run_once(now=rec["now"])
        outputs = rj.collect_outputs(autoscaler, status)
        digests = rj.surface_digests(outputs)
        drifted = sorted(k for k in rec["digests"]
                         if digests.get(k) != rec["digests"][k])
        entry: dict = {"loop": rec["loop"], "record": rec["digest"],
                       "kind": rec["kind"], "surfaces": digests,
                       "drift": drifted,
                       # execution-mode provenance, recorded vs replayed
                       # (docs/FUSED_LOOP.md): surface digests are mode-
                       # independent, so a fusedMode mismatch here is
                       # informational, never drift — it also lets the
                       # report verify the phased twin saw identical worlds
                       # even when the recorder harvested a SPECULATIVE
                       # result for the loop
                       "fusedMode": {"recorded": rec.get("fusedMode", ""),
                                     "replayed": status.fused_mode},
                       "loopDeviceRoundTrips": {
                           "recorded": rec.get("loopDeviceRoundTrips"),
                           "replayed": status.loop_device_round_trips},
                       "speculation": {"recorded": rec.get("speculation",
                                                           ""),
                                       "replayed": status.speculation}}
        if drifted:
            drift_loops.append(rec["loop"])
            vdiff = _verdict_diff(rec, outputs)
            entry["verdictDiff"] = vdiff
            entry["scaleUpDiff"] = {
                "recorded": rec["outputs"]["scaleUp"],
                "replayed": outputs["scaleUp"],
            } if "scaleUp" in drifted else None
            entry["drainDiff"] = {
                "recorded": rec["outputs"]["drain"],
                "replayed": outputs["drain"],
            } if "drain" in drifted else None
            groups = {d["group"] for d in vdiff} or None
            entry["reasonDiff"] = _reason_plane_diff(rec, world, groups,
                                                     autoscaler.device)
        elif diff:
            # clean loop under --diff: localize over ALL pending rows
            # (None — an empty set would filter every group out)
            entry["reasonDiff"] = _reason_plane_diff(rec, world, None,
                                                     autoscaler.device)
        loops.append(entry)
    report = {
        "journal": path,
        "loops": len(loops),
        "firstLoop": records[0]["loop"],
        "driftLoops": drift_loops,
        "zeroDrift": not drift_loops,
        "problems": problems,
        # fingerprinted WITHOUT the replay-side neutralizations (journal/
        # flight-recorder paths, wallclock budget) — those are replay
        # hygiene, not config drift; a faithful same-version replay matches
        "config": {"recorded": meta.get("config", ""),
                   "replayed": rj.options_fingerprint(
                       options_from_meta(meta, neutralize=False))},
        "backend": {"recorded": records[-1].get("backend", {}),
                    "replayed": rj.backend_identity(
                        autoscaler.device, options.node_shape_bucket,
                        options.group_shape_bucket)},
        "records": loops,
    }
    if records[0]["loop"] != 0:
        # rotation pruned the journal's origin: cross-loop autoscaler state
        # (unneeded clocks, backoffs) could not be rebuilt from loop 0 —
        # stateful surfaces (drain) may legitimately differ
        report["stateHorizon"] = records[0]["loop"]
    lossy = sorted({s for rec in records
                    for s in (rec.get("fidelity") or {}).get(
                        "unrecordedSources", [])})
    if lossy:
        # the recorder's source exposed surfaces the v1 record format does
        # not carry (PDBs, workloads, DRA/CSI…) — replay may legitimately
        # drift on loops where they influenced a decision
        report["fidelity"] = {"unrecordedSources": lossy}
    aud = getattr(autoscaler, "shadow_auditor", None)
    if aud is not None:
        # the replayed audit's sample provenance: loop-for-loop equal to
        # the recorder's sample_log when the journal is faithful (the
        # determinism pin in tests/test_shadow_audit.py)
        report["audit"] = {
            "samples": list(aud.sample_log),
            "checks": {s: dict(c) for s, c in aud.checks.items()},
            "divergences": aud.divergences,
        }
    if keep_autoscaler:
        report["_autoscaler"] = autoscaler
    return report

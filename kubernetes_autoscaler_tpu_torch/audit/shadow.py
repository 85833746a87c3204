"""Online shadow audit: continuous sampled fidelity verification of TPU
verdicts (docs/OBSERVABILITY.md "Shadow audit").

Every fidelity check before this layer was OFFLINE: the property suites,
the replay oracle, the cross-encode-mode oracle. In production
a silently miscompiled kernel, a corrupted HBM buffer, or a stale resident
plane emits *wrong autoscaling decisions with perfect-looking metrics* —
the backend supervisor survives a device that hangs, but nothing before
this detected a device that is fast and wrong. The ShadowAuditor closes
that gap: each RunOnce it draws a deterministic, journal-cursor-seeded
sample of the loop's device verdicts and re-derives them through an
independent host path:

  plane    the whole filter-out-schedulable verdict plane, digest-compared
           against an independent re-fetch of the SAME device buffer — a
           corrupted fetch (or an unstable read) diverges. Runs every
           audited loop (it costs one tiny d2h transfer), so a corruption
           is detected within ONE loop of appearing.
  scaleup  K sampled (pod-group × node) predicate verdicts: the device
           re-evaluates `ops/predicates.reason_mask` over the sampled
           groups (one masked dispatch) and the host recomputes the SAME
           uint16 reason bits from the encoder's mirrors
           (`ops/predicates.host_reason_row`, the numpy twin built on the
           host_predicate_row hash contract). A divergence names the exact
           flipped bits — the replay's drift-localization vocabulary,
           online.
  drain    K sampled DRAINABLE verdicts, re-checked through the planner's
           ConfirmOracle reference path: the device's claimed per-pod
           destinations are replayed move-by-move against the exact host
           oracle (utils/oracle_cache.ConfirmOracle). Only the unsafe
           direction is audited — a false "drainable" deletes a node;
           a false "unremovable" merely waits.

Sampling determinism (docs/REPLAY.md "Shadow-audit cursor seeding"): the
sample for loop k is seeded by the journal cursor AT THE TOP of loop k —
record k-1's digest plus the loop index — hashed through sha256, never a
process RNG. Replaying a journal reproduces the record digests, therefore
the seeds, therefore the exact cells audited: a recorded divergence is
re-examinable offline.

Budget (the audit must never become the hot path): a token bucket refilled
per loop with `--shadow-audit-budget-ms` (or, at the default 0, an
adaptive ~0.5% of the loop-walltime EWMA — half the 1% overhead target,
leaving headroom). Each step spends its measured cost; a step only starts
while the bucket is positive, so expensive loops push the bucket negative
and later loops skip (counted as outcome=skipped in
`shadow_audit_checks_total{surface,outcome}`) until the debt amortizes.
The first execution of each step is jit/oracle warmup and is forgiven
(recorded as `warmup_ms`), mirroring how the bench excludes loop 0. The
always-on plane check and a pending post-heal re-audit bypass the bucket.

Divergence is ACTED ON, not just counted (the supervisor coupling lives in
core/static_autoscaler.py): a self-contained evidence bundle is written,
the BackendSupervisor ladder takes healthy→suspect with
cause="audit_divergence", the WorldStore is heal()ed with a FORCED
full/audit_divergence re-encode, and the same sample is re-audited once —
persistent divergence degrades the backend (scale-down withheld, scale-up
refused with the `AuditDivergence` reason) instead of actuating on
corrupt bits.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np

from kubernetes_autoscaler_tpu_torch.metrics import trace as _trace
from kubernetes_autoscaler_tpu_torch.ops.hostfetch import to_host

AUDIT_SURFACES = ("plane", "scaleup", "drain")

AUDIT_CHECKS_HELP = ("Shadow-audit verdict re-checks, by surface "
                     "(plane / scaleup / drain) and outcome "
                     "(ok / divergent / skipped)")
AUDIT_OVERHEAD_HELP = ("Wall-clock seconds spent in the shadow audit "
                       "(budget-bounded; the bench reports the fraction)")

# adaptive refill when --shadow-audit-budget-ms is 0: half the 1% overhead
# target, as a fraction of the loop-walltime EWMA
_ADAPTIVE_FRAC = 0.005
# the bucket never banks more than this many CURRENT refills: a long idle
# stretch (or one cold compile-inflated loop feeding the EWMA) must not
# bank enough to audit every loop for dozens of loops — the cap is applied
# against the current refill, so an inflated grant deflates as the EWMA
# converges to the steady loop
_BUCKET_CAP_REFILLS = 4.0


def sample_indices(seed: str, tag: str, k: int, n: int) -> list[int]:
    """k distinct indices in [0, n), derived from a sha256 stream over
    (seed, tag, counter) — deterministic and platform/process independent
    (NOT random.Random: the journal replay contract demands byte-stable
    sampling across interpreters). Same seed ⇒ same cells."""
    if n <= 0 or k <= 0:
        return []
    out: list[int] = []
    seen: set[int] = set()
    ctr = 0
    want = min(k, n)
    # 64 draws per wanted index bounds the worst-case collision walk
    while len(out) < want and ctr < 64 * want + 64:
        h = hashlib.sha256(f"{seed}:{tag}:{ctr}".encode()).digest()
        ctr += 1
        idx = int.from_bytes(h[:8], "big") % n
        if idx not in seen:
            seen.add(idx)
            out.append(idx)
    return out


class ShadowAuditor:
    """One per StaticAutoscaler; owned and driven by the control-loop
    thread (no locks, like the JournalWriter)."""

    def __init__(self, registry=None, event_sink=None, samples: int = 4,
                 budget_ms: float = 0.0, bundle_dir: str = "", device=None):
        self.registry = registry
        # the loop's device, named in the evidence bundle's backend block
        self.device = device
        self.event_sink = event_sink
        self.samples = max(int(samples), 1)
        self.budget_ms = float(budget_ms)
        self.bundle_dir = bundle_dir
        # token bucket (ms); starts with one generous grant so loop 0 audits
        self.bucket_ms = 5.0
        self.loop_ewma_ms: float | None = None
        self._warmed: set[str] = set()
        self.warmup_ms = 0.0
        self.overhead_ns = 0
        self.loop_index = 0
        self.checks = {s: {"ok": 0, "divergent": 0, "skipped": 0}
                       for s in AUDIT_SURFACES}
        self.divergences = 0
        self.last_report: dict | None = None
        self.last_bundle_path = ""
        # per-loop sample provenance (bounded): {"loop", "seed", "cells",
        # "drain"} — the replay determinism pin reads this
        self.sample_log: list[dict] = []
        # the divergent sample awaiting its single post-heal re-audit;
        # persistent divergence (re-audit diverges again) sets `degraded`
        self.pending_recheck: dict | None = None
        self.degraded = False
        # captured per loop by StaticAutoscaler
        self._ctx: dict | None = None
        self._seed = ""
        # replay stitching (replay/harness.py): the replayed autoscaler
        # has no live journal, so the harness feeds each record's `parent`
        # digest here — the SAME cursor the recorder seeded from, so the
        # replay reproduces the exact cells (docs/REPLAY.md)
        self.parent_override: str | None = None

    # ---- wiring points (StaticAutoscaler) --------------------------------

    def scale_up_untrusted(self) -> bool:
        """Orchestrator gate: True while a persistent audit divergence is
        unhealed — every scale-up option would be derived from a verdict
        plane the audit proved corrupt, so all are refused with the
        AuditDivergence reason."""
        return self.degraded

    def capture_world(self, enc, parent_digest: str = "") -> None:
        """Pin the pre-placement device tensors + host mirrors of this
        loop's encode (the loop replaces these tensors out of place and never
        writes into them, so holding the references keeps the exact planes
        the verdicts were computed from alive even after the snapshot layers
        replace enc.nodes/enc.specs; tests/test_torch_shadow_audit.py pins
        their `_version` across a loop). The sample
        seed is the journal cursor at the TOP of the loop: the previous
        record's digest — the cursor a replay of this loop runs under."""
        if not parent_digest and self.parent_override is not None:
            parent_digest = self.parent_override
        self._seed = f"{parent_digest}:{self.loop_index}"
        self._ctx = {
            "nodes_t": enc.nodes,
            "specs_t": enc.specs,
            "mirrors": enc.host_arrays,
            "scheduled_pods": enc.scheduled_pods,
            "node_objs": enc.node_objs,
            "registry": enc.registry,
            "namespaces": enc.namespaces,
            "verdict_dev": None,
            "verdict_host": None,
        }

    def capture_verdict(self, verdict_dev, verdict_host) -> None:
        """The filter-out-schedulable plane: the device array (truth) and
        the fetched host copy every downstream consumer (journal, status,
        scale-up) actually reads."""
        if self._ctx is not None:
            self._ctx["verdict_dev"] = verdict_dev
            self._ctx["verdict_host"] = verdict_host

    def note_healed(self) -> None:
        """StaticAutoscaler ran the forced post-divergence rebuild: the
        pending sample's re-audit is now meaningful (it runs against a
        cold re-encode, so a second divergence really is persistent)."""
        if self.pending_recheck is not None:
            self.pending_recheck["healed"] = True

    def note_loop_ms(self, loop_ms: float) -> None:
        """Loop-walltime EWMA feed (run_once's finally) — the adaptive
        budget's denominator. The first loop is compile-dominated (often
        100× a steady loop): a later sample far below the current estimate
        resets it outright, and upward outliers are clamped, so the EWMA
        tracks the STEADY loop rather than letting one cold loop inflate
        the audit budget for dozens of loops."""
        if self.loop_ewma_ms is None:
            self.loop_ewma_ms = loop_ms
        elif loop_ms < 0.25 * self.loop_ewma_ms:
            self.loop_ewma_ms = loop_ms
        else:
            self.loop_ewma_ms = (0.8 * self.loop_ewma_ms
                                 + 0.2 * min(loop_ms,
                                             4.0 * self.loop_ewma_ms))

    # ---- budget ----------------------------------------------------------

    def _refill(self) -> float:
        if self.budget_ms > 0:
            return self.budget_ms
        return max(_ADAPTIVE_FRAC * (self.loop_ewma_ms or 10.0), 0.05)

    def _spend(self, step: str, cost_ms: float) -> None:
        if step not in self._warmed:
            # first execution = jit/oracle warmup; forgiven, like the
            # bench excludes loop 0 — steady-state stays budget-honest
            self._warmed.add(step)
            self.warmup_ms += cost_ms
            return
        self.bucket_ms -= cost_ms

    def _count(self, surface: str, outcome: str, n: int = 1,
               **labels) -> None:
        self.checks[surface][outcome] += n
        if self.registry is not None:
            self.registry.counter(
                "shadow_audit_checks_total", help=AUDIT_CHECKS_HELP).inc(
                n, surface=surface, outcome=outcome, **labels)

    # ---- the per-loop entry ---------------------------------------------

    def run_once_audit(self, planner=None, cursor=None, now: float = 0.0,
                       trace_id: str = "") -> dict | None:
        """Audit this loop's captured verdicts. Returns None when nothing
        was captured; otherwise a report dict — `divergent` True means the
        caller (StaticAutoscaler) must drive the supervisor ladder, and
        `persistent` True means the post-heal re-audit diverged AGAIN."""
        ctx, self._ctx = self._ctx, None
        if ctx is None or ctx["mirrors"] is None:
            return None
        t0 = time.perf_counter_ns()
        loop = self.loop_index
        self.loop_index += 1
        seed = self._seed
        refill = self._refill()
        self.bucket_ms = min(self.bucket_ms + refill,
                             _BUCKET_CAP_REFILLS * refill)
        report = {"loop": loop, "seed": seed, "divergent": False,
                  "persistent": False, "divergences": [], "cells": [],
                  "drainCandidates": [], "skipped": []}
        tracer = _trace.current_tracer()
        span = tracer.begin("shadow_audit", cat="audit", loop=loop) \
            if tracer is not None else None
        try:
            # the single re-audit of a divergent sample is only meaningful
            # AFTER the forced rebuild ran (note_healed): while the
            # supervisor ladder has not yet let the heal happen (e.g. it
            # degraded immediately from `recovering`), re-checking the
            # un-rebuilt world would convict a healable corruption as
            # "persistent" — hold the pending sample instead
            recheck = (self.pending_recheck
                       if (self.pending_recheck is not None
                           and self.pending_recheck.get("healed"))
                       else None)
            # 1) plane digest: always on — one tiny independent d2h fetch;
            #    the within-one-loop detection guarantee rides this step
            s0 = time.perf_counter_ns()
            self._audit_plane(ctx, report)
            self._spend("plane", (time.perf_counter_ns() - s0) / 1e6)
            # 2) scaleup cells (bucket-gated; a pending re-audit bypasses
            #    the bucket — the heal protocol mandates it)
            if recheck is not None and recheck.get("cells"):
                s0 = time.perf_counter_ns()
                self._audit_scaleup(ctx, report, recheck["cells"])
                self._spend("scaleup", (time.perf_counter_ns() - s0) / 1e6)
            elif self.bucket_ms > 0:
                cells = self._pick_cells(ctx, seed)
                if cells:
                    s0 = time.perf_counter_ns()
                    self._audit_scaleup(ctx, report, cells)
                    self._spend("scaleup",
                                (time.perf_counter_ns() - s0) / 1e6)
            else:
                self._count("scaleup", "skipped", self.samples)
                report["skipped"].append("scaleup:budget")
            # 3) drain verdicts (bucket-gated)
            if self.bucket_ms > 0 or (recheck is not None
                                      and recheck.get("drain")):
                s0 = time.perf_counter_ns()
                self._audit_drain(ctx, planner, report, seed,
                                  forced=(recheck or {}).get("drain"))
                self._spend("drain", (time.perf_counter_ns() - s0) / 1e6)
            else:
                self._count("drain", "skipped", self.samples)
                report["skipped"].append("drain:budget")

            self.sample_log.append({"loop": loop, "seed": seed,
                                    "cells": list(report["cells"]),
                                    "drain": list(
                                        report["drainCandidates"])})
            if len(self.sample_log) > 256:
                del self.sample_log[:-256]

            if report["divergences"]:
                report["divergent"] = True
                self.divergences += 1
                if recheck is not None:
                    # the single post-heal re-audit diverged AGAIN: the
                    # divergence survives a forced cold re-encode — this
                    # is persistent, the backend degrades
                    report["persistent"] = True
                    self.degraded = True
                self.pending_recheck = {
                    "cells": list(report["cells"]),
                    "drain": list(report["drainCandidates"]),
                    "loop": loop,
                    # set by note_healed() when the forced rebuild runs;
                    # the re-audit waits for it
                    "healed": False,
                }
                report["bundlePath"] = self._write_bundle(
                    report, cursor, trace_id, now)
                self._emit_events(report, now)
            elif recheck is not None:
                # the re-audit of the divergent sample came back clean:
                # the forced re-encode healed it — stand down
                self.pending_recheck = None
                self.degraded = False
            self.last_report = report
            return report
        finally:
            dt_ns = time.perf_counter_ns() - t0
            self.overhead_ns += dt_ns
            if self.registry is not None:
                self.registry.counter(
                    "shadow_audit_overhead_seconds_total",
                    help=AUDIT_OVERHEAD_HELP).inc(dt_ns / 1e9)
                self.registry.gauge(
                    "shadow_audit_pending_recheck",
                    help="1 while a divergent sample awaits its post-heal "
                         "re-audit (persistent divergence degrades the "
                         "backend)").set(
                    1.0 if self.pending_recheck is not None else 0.0)
            if tracer is not None:
                tracer.end(span,
                           divergent=bool(report["divergences"]),
                           cells=len(report["cells"]),
                           skipped=report["skipped"])

    # ---- surface 1: the verdict-plane digest ----------------------------

    def _audit_plane(self, ctx: dict, report: dict) -> None:
        dev = ctx.get("verdict_dev")
        host = ctx.get("verdict_host")
        if dev is None or host is None:
            self._count("plane", "skipped")
            report["skipped"].append("plane:no-verdict")
            return
        # a FRESH device read, not a host copy the consumer fetch already
        # made: adding 0 is a new device op producing a new tensor, so this
        # read really crosses from the device a second time.
        refetched = to_host(dev + 0).astype(np.int32)
        host = np.asarray(host).astype(np.int32)
        d_ref = hashlib.sha256(refetched.tobytes()).hexdigest()[:16]
        d_host = hashlib.sha256(host.tobytes()).hexdigest()[:16]
        report["planeDigest"] = d_ref
        if d_ref == d_host:
            self._count("plane", "ok")
            return
        self._count("plane", "divergent")
        rows = np.nonzero(refetched != host)[0] \
            if refetched.shape == host.shape else np.arange(host.shape[0])
        for r in rows[:8].tolist():
            dv = int(refetched[r]) if r < refetched.shape[0] else None
            hv = int(host[r]) if r < host.shape[0] else None
            report["divergences"].append({
                "surface": "plane", "row": int(r),
                "device": dv, "fetched": hv,
                "xorBits": (dv ^ hv) if dv is not None and hv is not None
                else None,
            })

    # ---- surface 2: sampled (pod-group × node) predicate cells ----------

    def _pick_cells(self, ctx: dict, seed: str) -> list[tuple[int, int]]:
        m = ctx["mirrors"]
        pending = np.nonzero(m["specs.valid"].astype(bool)
                             & (m["specs.count"] > 0))[0]
        valid_nodes = np.nonzero(m["nodes.valid"].astype(bool))[0]
        if pending.size == 0 or valid_nodes.size == 0:
            return []
        rows = sample_indices(seed, "scaleup-row", self.samples,
                              int(pending.size))
        cols = sample_indices(seed, "scaleup-col", self.samples,
                              int(valid_nodes.size))
        # K cells by pairing the row/col streams (a single pending group
        # still audits K distinct nodes; dedup keeps the set distinct)
        cells: list[tuple[int, int]] = []
        seen: set[tuple[int, int]] = set()
        for i in range(self.samples):
            cell = (int(pending[rows[i % len(rows)]]),
                    int(valid_nodes[cols[(i + i // len(cols))
                                         % len(cols)]]))
            if cell not in seen:
                seen.add(cell)
                cells.append(cell)
        return cells

    def _audit_scaleup(self, ctx: dict, report: dict,
                       cells: list) -> None:
        from kubernetes_autoscaler_tpu_torch.ops import predicates as preds

        m = ctx["mirrors"]
        cells = [tuple(c) for c in cells]
        g_dim = int(m["specs.valid"].shape[0])
        rows = sorted({gi for gi, _ in cells if 0 <= gi < g_dim})
        if not rows:
            self._count("scaleup", "skipped")
            return
        mask = np.zeros((g_dim,), dtype=bool)
        mask[rows] = True
        # one masked device dispatch over the sampled rows on the captured
        # planes' device, the rows gathered there (in int32: CUDA indexes no
        # uint16), one small fetch
        import torch

        dev = ctx["specs_t"].count.device
        bits_dev = to_host(preds.reason_mask_for_groups(
            ctx["nodes_t"], ctx["specs_t"], torch.from_numpy(mask).to(dev))
            .to(torch.int32)[torch.as_tensor(rows, device=dev)])
        report["cells"] = [[int(g), int(n)] for g, n in cells]
        row_of = {gi: k for k, gi in enumerate(rows)}
        host_rows = {gi: preds.host_reason_row(m, gi) for gi in rows}
        for gi, nj in cells:
            if gi not in row_of or nj >= bits_dev.shape[1]:
                self._count("scaleup", "skipped")
                continue
            dv = int(bits_dev[row_of[gi], nj])
            hv = int(host_rows[gi][nj])
            if dv == hv:
                self._count("scaleup", "ok")
                continue
            self._count("scaleup", "divergent")
            report["divergences"].append({
                "surface": "scaleup", "cell": [int(gi), int(nj)],
                "device": dv, "host": hv,
                "flipped": preds.reason_bit_names(dv ^ hv),
                "deviceReasons": preds.reason_bit_names(dv),
                "hostReasons": preds.reason_bit_names(hv),
            })

    # ---- surface 3: sampled drain verdicts (ConfirmOracle path) ---------

    def _audit_drain(self, ctx: dict, planner, report: dict, seed: str,
                     forced=None) -> None:
        """Re-check sampled DRAINABLE verdicts by replaying the device's
        claimed per-pod destinations against the planner's exact host
        oracle. Restricted to candidates whose movable pods are all
        exactly-encoded and unconstrained (the same screen the planner's
        native tier applies) — outside that, encoded and exact semantics
        legitimately differ and the planner's own confirm pass is already
        the authority; those samples count as skipped, never as drift."""
        st = getattr(planner, "state", None)
        removal = getattr(st, "removal", None)
        cand = getattr(st, "candidate_indices", None)
        if removal is None or cand is None or getattr(
                st, "injected_pods", None):
            self._count("drain", "skipped",
                        self.samples if forced is None else len(forced))
            report["skipped"].append("drain:no-candidates")
            return
        m = ctx["mirrors"]
        drainable = to_host(removal.drainable)
        pod_slot = to_host(removal.pod_slot)
        dest_node = to_host(removal.dest_node)
        cand = to_host(cand)
        drained_rows = np.nonzero(drainable[:cand.shape[0]])[0]
        if drained_rows.size == 0:
            return
        if forced:
            picked = [k for k in forced if k in set(drained_rows.tolist())]
        else:
            picked = [int(drained_rows[i]) for i in sample_indices(
                seed, "drain", self.samples, int(drained_rows.size))]
        if not picked:
            return
        from kubernetes_autoscaler_tpu_torch.utils.oracle_cache import (
            ConfirmOracle,
        )

        movable = m["scheduled.movable"].astype(bool)
        group_ref = m["scheduled.group_ref"]
        hostcheck = m["specs.needs_host_check"].astype(bool)
        constrained = np.zeros_like(hostcheck)
        if "specs.spread_kind" in m:
            constrained = ((m["specs.spread_kind"] > 0)
                           | (m["specs.aff_kind"] > 0)
                           | m["specs.anti_self_zone"].astype(bool))
        node_objs = ctx["node_objs"] or []
        sched = ctx["scheduled_pods"]
        report["drainCandidates"] = [int(k) for k in picked]
        # loop-invariant world view, built once: ConfirmOracle copies its
        # inputs in __init__, so the same dict/list seed every fresh
        # per-candidate oracle (rebuilding them per candidate was O(K×pods)
        # of budget spend converting later samples into skips)
        by_node: dict[str, list] = {}
        for q in sched:
            if q is not None:
                by_node.setdefault(q.node_name, []).append(q)
        live = [nd for nd in node_objs if nd is not None]
        for k in picked:
            c = int(cand[k])
            cand_node = node_objs[c] if c < len(node_objs) else None
            if cand_node is None:
                self._count("drain", "skipped")
                continue
            moves = []
            eligible = True
            for s in range(pod_slot.shape[1]):
                slot = int(pod_slot[k, s])
                if slot < 0 or slot >= len(sched) or not movable[slot]:
                    continue
                g = int(group_ref[slot])
                if hostcheck[g] or constrained[g]:
                    eligible = False
                    break
                moves.append((slot, int(dest_node[k, s])))
            if not eligible:
                self._count("drain", "skipped")
                report["skipped"].append(f"drain:{k}:inexact")
                continue
            # fresh per-candidate oracle (its __init__ copies the shared
            # world view): the device verdict is "drainable in isolation",
            # so each sample replays alone
            oracle = ConfirmOracle(live, by_node,
                                   registry=ctx["registry"],
                                   namespaces=ctx["namespaces"])
            bad = None
            for slot, dest in moves:
                pod = sched[slot]
                dest_obj = (node_objs[dest]
                            if 0 <= dest < len(node_objs) else None)
                if dest_obj is None or dest_obj.name == cand_node.name:
                    bad = {"slot": slot, "dest": int(dest),
                           "why": "no-destination-recorded"}
                    break
                if not oracle.check(pod, dest_obj):
                    from kubernetes_autoscaler_tpu_torch.ops.predicates import (
                        host_reason_row,
                        reason_bit_names,
                    )

                    hv = int(host_reason_row(m, int(group_ref[slot]))[dest])
                    bad = {"slot": slot, "dest": int(dest),
                           "destNode": dest_obj.name,
                           "why": "oracle-refused",
                           "hostReasons": reason_bit_names(hv)}
                    break
                oracle.move(pod, pod.node_name, dest_obj.name)
            if bad is None:
                self._count("drain", "ok")
            else:
                self._count("drain", "divergent")
                report["divergences"].append({
                    "surface": "drain", "candidate": int(k),
                    "node": cand_node.name, **bad})

    # ---- evidence --------------------------------------------------------

    def _write_bundle(self, report: dict, cursor, trace_id: str,
                      now: float) -> str:
        """One self-contained JSON evidence bundle per divergent loop:
        journal cursor + record digest, the sampled cells, device-vs-host
        verdicts with the per-bit reason diff, and the retained trace id —
        everything a post-mortem (or an offline replay of the named
        cursor) needs. Atomic write; a full disk never sinks the loop."""
        from kubernetes_autoscaler_tpu_torch.replay.journal import (
            backend_identity,
        )

        bundle = {
            "kind": "shadow-audit-divergence",
            "loop": report["loop"],
            "now": now,
            "seed": report["seed"],
            "journalCursor": list(cursor) if cursor is not None else None,
            "traceId": trace_id,
            "cells": report["cells"],
            "drainCandidates": report["drainCandidates"],
            "divergences": report["divergences"],
            "persistent": report["persistent"],
            "backend": backend_identity(self.device),
        }
        if not self.bundle_dir:
            return ""
        try:
            os.makedirs(self.bundle_dir, exist_ok=True)
            path = os.path.join(
                self.bundle_dir,
                f"audit-{report['loop']:06d}-{trace_id or 'notrace'}.json")
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(bundle, f, indent=1)
            os.replace(tmp, path)
        except OSError:
            return ""
        self.last_bundle_path = path
        if self.registry is not None:
            self.registry.counter(
                "shadow_audit_bundles_total",
                help="Divergence evidence bundles persisted").inc()
        return path

    def _emit_events(self, report: dict, now: float) -> None:
        if self.event_sink is None:
            return
        for d in report["divergences"][:4]:
            obj = (f"cell-{d['cell'][0]}x{d['cell'][1]}"
                   if "cell" in d else
                   d.get("node") or f"row-{d.get('row', '?')}")
            self.event_sink.emit(
                "AuditDivergence", obj=obj, reason=d["surface"],
                message=(f"device verdict diverged from the host oracle "
                         f"on the {d['surface']} surface"
                         + (f" (flipped: {', '.join(d['flipped'])})"
                            if d.get("flipped") else "")),
                now=now)

    # ---- surfaces --------------------------------------------------------

    def snapshot_payload(self) -> dict:
        """The /snapshotz + Statusz audit section."""
        return {
            "loop": self.loop_index,
            "checks": {s: dict(c) for s, c in self.checks.items()},
            "divergences": self.divergences,
            "degraded": self.degraded,
            "pendingRecheck": (dict(self.pending_recheck)
                               if self.pending_recheck else None),
            "lastBundle": self.last_bundle_path,
            "overheadMs": round(self.overhead_ns / 1e6, 3),
            "warmupMs": round(self.warmup_ms, 3),
            "bucketMs": round(self.bucket_ms, 3),
        }

    def stats(self) -> dict:
        ok = sum(c["ok"] for c in self.checks.values())
        skipped = sum(c["skipped"] for c in self.checks.values())
        return {**self.snapshot_payload(), "ok": ok, "skipped": skipped}

"""Render lineage answers: `why`, `timeline`, `diff` as causal-chain text
or JSON, plus the follow-mode tail loop the CLI and CI smoke share.

The text renderer's job is a one-line causal story:

    pending since loop 12: refused cpu×3 templates, taint×2
      -> loop 14 scale-up won option ng-2
      -> bound loop 15

so `why` coalesces an object's raw per-loop entries into SEGMENTS — runs
of identical verdicts become one line with a loop range and aggregated
constraint counts — and renders artifacts/transitions as indented
evidence pointers under the loop they stitch to."""

from __future__ import annotations

import json
import time


def parse_object(spec: str) -> tuple[str, str]:
    """'node/worker-3' → ('node', 'worker-3'). Kind-less specs default to
    pod-group — the kind `why` is asked about most."""
    if "/" in spec:
        kind, name = spec.split("/", 1)
        return kind, name
    return "pod-group", spec


def parse_loops(spec: str) -> tuple[int | None, int | None]:
    """'A..B' | 'A..' | '..B' | 'K' → (lo, hi)."""
    if ".." not in spec:
        k = int(spec)
        return k, k
    lo, hi = spec.split("..", 1)
    return (int(lo) if lo else None), (int(hi) if hi else None)


def coalesce_segments(entries: list[dict]) -> list[dict]:
    """Runs of same-verdict loops → one segment with a loop range. The
    refusal constraint counts aggregate (taint×2 across the run)."""
    segs: list[dict] = []
    for e in entries:
        ev = e.get("event", "")
        prev = segs[-1] if segs else None
        same = (prev is not None and prev["event"] == ev
                and prev.get("reason") == e.get("reason")
                and ev in ("refused", "unneeded", "unremovable")
                and e["loop"] <= prev["loops"][1] + 1)
        if same:
            prev["loops"][1] = e["loop"]
            prev["count"] += 1
            for c, n in (e.get("constraints") or {}).items():
                prev.setdefault("constraints", {})
                prev["constraints"][c] = prev["constraints"].get(c, 0) + n
        else:
            seg = {"event": ev, "loops": [e["loop"], e["loop"]],
                   "count": 1}
            for k in ("reason", "detail", "error", "delta", "won", "pods",
                      "waste", "price", "pendingSince", "afterScaleUp",
                      "path", "eventKind", "message"):
                if k in e:
                    seg[k] = e[k]
            if e.get("constraints"):
                seg["constraints"] = dict(e["constraints"])
            segs.append(seg)
    return segs


def _loops_label(lo: int, hi: int) -> str:
    return f"loop {lo}" if lo == hi else f"loops {lo}..{hi}"


def _constraints_label(counts: dict) -> str:
    return ", ".join(f"{c}×{n}" for c, n in
                     sorted(counts.items(), key=lambda kv: -kv[1]))


def _segment_line(seg: dict) -> str:
    lo, hi = seg["loops"]
    ev = seg["event"]
    where = _loops_label(lo, hi)
    if ev == "refused":
        line = f"pending since loop {lo}: refused {seg.get('reason', '')}"
        if seg.get("constraints"):
            line += f" [{_constraints_label(seg['constraints'])}]"
        if hi != lo:
            line += f" (through loop {hi})"
        return line
    if ev == "resolved":
        line = f"{where}: resolved"
        asu = seg.get("afterScaleUp")
        if asu:
            line += f" after loop {asu['loop']} scale-up won {asu['won']}"
        return line
    if ev == "scale-up":
        line = f"{where}: scale-up +{seg.get('delta', 0)}"
        if seg.get("won"):
            line += (f" — won option (pods={seg.get('pods')},"
                     f" waste={seg.get('waste')}, price={seg.get('price')})")
        return line
    if ev == "scale-up-error":
        return f"{where}: scale-up error {seg.get('error', '')}"
    if ev == "unremovable":
        return f"{where}: unremovable ({seg.get('reason', '')})"
    if ev == "drain-fail":
        return f"{where}: drain failed ({seg.get('detail', '')})"
    if ev == "unneeded":
        return f"{where}: unneeded (scale-down candidate)"
    if ev == "scale-down-deleted":
        return f"{where}: scaled down (deleted)"
    if ev == "event":
        line = (f"{where}: event {seg.get('eventKind', '')}"
                f"/{seg.get('reason', '')} ×{seg.get('count', 1)}")
        if seg.get("message"):
            line += f" — {seg['message']}"
        return line
    if ev.startswith("artifact:"):
        return f"{where}: {ev[len('artifact:'):]} {seg.get('path', '')}"
    return f"{where}: {ev}"


def render_why(ans: dict, as_json: bool = False) -> str:
    ans = dict(ans, segments=coalesce_segments(ans.get("entries") or []))
    if as_json:
        return json.dumps(ans, indent=2, sort_keys=True, default=str)
    lines = [f"why {ans['object']}" +
             (f"  (run {ans['run'][:12]})" if ans.get("run") else "")]
    if not ans.get("found"):
        lines.append("  no lineage recorded for this object")
        return "\n".join(lines)
    if ans.get("droppedEntries"):
        lines.append(f"  [{ans['droppedEntries']} middle entries dropped"
                     " by the per-object bound]")
    for seg in ans["segments"]:
        lines.append("  " + _segment_line(seg))
    arts = ans.get("artifacts") or []
    if arts:
        lines.append("  evidence:")
        for a in arts:
            extra = []
            if a.get("traceId"):
                extra.append(f"trace={a['traceId']}")
            if a.get("persistent"):
                extra.append("persistent")
            if a.get("detail"):
                extra.append(a["detail"])
            lines.append(f"    loop {a.get('loop', '?')}: {a['kind']}"
                         f" {a.get('path', '')}"
                         + (f"  ({', '.join(extra)})" if extra else ""))
    trans = ans.get("transitions") or []
    for t in trans:
        lines.append(f"  backend: loop {t['loop']} {t['from']} -> {t['to']}"
                     + (f" ({t['cause']})" if t.get("cause") else ""))
    for ev in ans.get("events") or []:
        lines.append(f"  event-ring: {ev.get('kind', '')}"
                     f"/{ev.get('reason', '')} ×{ev.get('count', 1)}")
    return "\n".join(lines)


def render_timeline(rows: list[dict], as_json: bool = False) -> str:
    if as_json:
        return json.dumps(rows, indent=2, sort_keys=True, default=str)
    lines = []
    for r in rows:
        bits = [f"loop {r['loop']:>4}", f"pending={r['pending']}",
                f"scheduled={r['scheduled']}"]
        if r.get("refused"):
            bits.append(f"refused={r['refused']}")
        su = r.get("scaleUp")
        if su:
            incs = ",".join(f"{g}+{d}" for g, d in
                            sorted(su.get("increases", {}).items()))
            bits.append(f"scale-up won {su.get('won', '')} [{incs}]")
        if r.get("unneeded"):
            bits.append(f"unneeded={r['unneeded']}")
        if r.get("deleted"):
            bits.append(f"deleted={r['deleted']}")
        if r.get("aborted"):
            bits.append(f"ABORTED({r['aborted']})")
        for a in r.get("artifacts") or ():
            bits.append(f"<{a['kind']}>")
        lines.append("  ".join(bits))
    return "\n".join(lines) if lines else "(no loops in range)"


def render_diff(d: dict, as_json: bool = False) -> str:
    if as_json:
        return json.dumps(d, indent=2, sort_keys=True, default=str)
    lines = [f"diff loop {d['loop'] - 1} -> {d['loop']}"]
    if d.get("pendingDelta") is not None:
        sign = "+" if d["pendingDelta"] >= 0 else ""
        lines.append(f"  pending {sign}{d['pendingDelta']}")
    su = d.get("scaleUp")
    if su:
        lines.append(f"  scale-up won {su.get('won', '')}")
    for e in d.get("appeared") or ():
        lines.append(f"  + {e['object']}: {e.get('event', '')}"
                     + (f" ({e['reason']})" if e.get("reason") else ""))
    for e in d.get("resolved") or ():
        was = e.get("was") or {}
        lines.append(f"  - {e['object']}: was {was.get('event', '')}"
                     + (f" ({was['reason']})" if was.get("reason") else ""))
    for e in d.get("changed") or ():
        was, now = e.get("was") or {}, e.get("now") or {}
        lines.append(f"  ~ {e['object']}: {was.get('event', '')}"
                     f" -> {now.get('event', '')}")
    for a in d.get("artifacts") or ():
        lines.append(f"  evidence: {a['kind']} {a.get('path', '')}")
    if len(lines) == 1:
        lines.append("  (no object-level changes)")
    return "\n".join(lines)


def render_runs(runs: list[dict], selected: str,
                as_json: bool = False) -> str:
    if as_json:
        return json.dumps({"runs": runs, "selected": selected},
                          indent=2, sort_keys=True)
    lines = []
    for r in runs:
        mark = "*" if selected and r["head"] == selected else " "
        lines.append(f"{mark} {r['head'][:16]}  loops"
                     f" {r.get('firstLoop', '?')}..{r.get('lastLoop', '?')}"
                     f"  records={r.get('records', 0)}")
    return "\n".join(lines) if lines else "(no runs found)"


def follow(index, on_new, poll_s: float = 0.25,
           max_wait_s: float | None = None,
           until_loop: int | None = None,
           sleep=time.sleep, clock=time.monotonic) -> bool:
    """Tail a LineageIndex: refresh() until `until_loop` lands in the
    selected run (True) or `max_wait_s` elapses (False; forever when
    None). on_new(count, index) fires after each refresh that ingested
    records — the CLI prints deltas, the CI smoke asserts pickup."""
    deadline = None if max_wait_s is None else clock() + max_wait_s
    while True:
        n = index.refresh()
        if n:
            on_new(n, index)
        if until_loop is not None and index.last_loop is not None \
                and index.last_loop >= until_loop:
            return True
        if deadline is not None and clock() >= deadline:
            return False
        sleep(poll_s)

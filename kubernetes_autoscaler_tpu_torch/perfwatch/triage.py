"""Auto-triage: every confirmed regression becomes ONE self-contained
evidence bundle (the shadow-audit bundle discipline, audit/shadow.py):
everything a human needs to start bisecting, in one JSON file — no
chasing CI logs that will have rotated away by the time anyone looks.

Bundle anatomy (docs/BENCH.md "Trajectory & regression gate"):

  * the verdict — metric/key, lineage, direction, delta vs the rolling
    baseline median, band width, severity;
  * the baseline window — (run, commit, ts, value) per baseline row, so
    "regressed against WHAT" is answerable offline;
  * censusDiff — compile-census variant diff vs the newest baseline row
    (added/removed variants, compile-count or cost drift): a new jit
    variant appearing alongside a latency regression is usually the
    whole story;
  * phaseDiff — per-phase / per-span deltas (baseline median vs current)
    from the flattened `phases.*` / `spans.*` keys: says WHERE in
    encode → compile → dispatch → fetch the time went;
  * counterDiff — movement counters (h2d bytes, steady_state_recompiles,
    loop_device_round_trips, dispatches, drops);
  * traceId / journalCursor when the record carries them — the handles
    into the Perfetto dump and the flight journal for full replay.

Writes are atomic (tmp + os.replace) and an OSError never sinks the
caller — triage is evidence, not control flow.
"""

from __future__ import annotations

import json
import os
import re
import statistics

_COUNTER_RE = re.compile(
    r"(bytes|recompile|round_trips|dispatch|drops|deaths|deferrals"
    r"|resends|h2d|d2h)", re.IGNORECASE)
_PHASE_RE = re.compile(r"^(phases\.|spans\.)")

_BUNDLES_HELP = "Perf-regression triage bundles written"


def _census_variants(record: dict) -> dict[str, dict]:
    """Normalize the record's compile-census evidence to a map keyed by
    `fn@shape_sig`. bench's primary line carries one census record dict;
    the device-stats line carries a list; tolerate both plus fn-keyed
    maps."""
    census = record.get("compile_census")
    if census is None and isinstance(record.get("device"), dict):
        census = record["device"].get("compile_census")
    out: dict[str, dict] = {}
    if isinstance(census, dict) and "fn" in census:
        census = [census]
    if isinstance(census, dict):
        census = list(census.values())
    if not isinstance(census, list):
        return out
    for rec in census:
        if isinstance(rec, dict) and rec.get("fn"):
            out[f"{rec.get('fn')}@{rec.get('shape_sig', '')}"] = rec
    return out


def census_diff(current: dict, baseline: dict) -> dict:
    """Variant-level diff of two records' compile censuses."""
    cur = _census_variants(current)
    base = _census_variants(baseline)
    changed = {}
    for k in sorted(cur.keys() & base.keys()):
        delta = {}
        for field in ("compiles", "flops", "bytes_accessed", "temp_bytes",
                      "tenants"):
            a, b = base[k].get(field), cur[k].get(field)
            if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
                    and a != b:
                delta[field] = {"baseline": a, "current": b}
        if delta:
            changed[k] = delta
    return {
        "added": sorted(cur.keys() - base.keys()),
        "removed": sorted(base.keys() - cur.keys()),
        "changed": changed,
    }


def _metric_deltas(pattern: re.Pattern, row: dict,
                   baselines: list[dict]) -> dict:
    """baseline-median vs current for every flattened key matching
    `pattern` — shared shape of phaseDiff and counterDiff."""
    out = {}
    cur = row.get("metrics") or {}
    for key in sorted(cur):
        if not pattern.search(key):
            continue
        series = [r["metrics"][key] for r in baselines
                  if isinstance(r.get("metrics", {}).get(key),
                                (int, float))]
        if not series:
            out[key] = {"current": cur[key], "baseline_median": None,
                        "delta": None}
            continue
        med = float(statistics.median(series))
        out[key] = {"current": cur[key], "baseline_median": med,
                    "delta": cur[key] - med}
    return out


def build_bundle(verdict, row: dict, baselines: list[dict]) -> dict:
    record = row.get("record") or {}
    newest_base = baselines[-1] if baselines else {}
    bundle = {
        "kind": "perf-regression",
        "v": 1,
        "metric": verdict.metric,
        "key": verdict.key,
        "lineage": verdict.lineage,
        "shapeSig": verdict.shape_sig,
        "run": row.get("run", ""),
        "commit": row.get("commit", ""),
        "ts": row.get("ts"),
        "backend": row.get("backend"),
        "fingerprint": row.get("fingerprint"),
        "verdict": verdict.to_dict(),
        "baselineWindow": [
            {"run": r.get("run", ""), "commit": r.get("commit", ""),
             "ts": r.get("ts"), "seq": r.get("seq"),
             "value": (r.get("metrics") or {}).get(verdict.key)}
            for r in baselines
        ],
        "censusDiff": census_diff(record,
                                  (newest_base.get("record") or {})),
        "phaseDiff": _metric_deltas(_PHASE_RE, row, baselines),
        "counterDiff": _metric_deltas(_COUNTER_RE, row, baselines),
    }
    # the replay handles, when the run carried them
    for src_key, dst_key in (("trace_id", "traceId"),
                             ("traceId", "traceId"),
                             ("journal_cursor", "journalCursor"),
                             ("journalCursor", "journalCursor"),
                             ("journal", "journalDir")):
        if record.get(src_key) is not None and dst_key not in bundle:
            bundle[dst_key] = record[src_key]
    return bundle


def write_bundle(bundle: dict, out_dir: str, registry=None) -> str:
    """Atomic write; returns the path, or '' when the filesystem refused
    (evidence best-effort, never fatal)."""
    name = re.sub(r"[^A-Za-z0-9._-]", "_",
                  f"perf-{bundle.get('metric', 'unknown')}"
                  f"-{bundle.get('key', '')}-{bundle.get('run', '')}")
    path = os.path.join(out_dir, name + ".json")
    try:
        os.makedirs(out_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(bundle, f, indent=1, default=str)
            f.write("\n")
        os.replace(tmp, path)
    except OSError:
        return ""
    if registry is not None:
        registry.counter("perf_triage_bundles_total",
                         help=_BUNDLES_HELP).inc(
            metric=str(bundle.get("metric", "unknown")))
    return path

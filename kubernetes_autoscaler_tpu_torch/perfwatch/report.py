"""Rendering: terminal trajectory table, markdown report, verdict lines,
and the bench --all per-mode summary table.

Everything here is pure text over already-loaded rows/verdicts — no
store access, no clock, no registry — so the sidecar Statusz page and
the CLI share one implementation.
"""

from __future__ import annotations


def fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1000:
            return f"{v:,.0f}"
        if abs(v) >= 1:
            return f"{v:.3g}"
        return f"{v:.3g}"
    return str(v)


def _series_key(row: dict) -> tuple:
    return (str(row.get("metric") or ""), str(row.get("lineage") or ""),
            str(row.get("shape_sig") or ""))


def group_series(rows: list[dict]) -> dict[tuple, list[dict]]:
    """(metric, lineage, shape_sig) → chronological non-dropped rows."""
    out: dict[tuple, list[dict]] = {}
    for r in rows:
        if r.get("dropped"):
            continue
        out.setdefault(_series_key(r), []).append(r)
    return out


def trajectory_lines(rows: list[dict], lineage: str | None = None,
                     last: int = 8) -> list[str]:
    """One line per (metric, lineage, shape) series: the last `last`
    headline values, oldest → newest."""
    out = []
    for (metric, lin, sig), series in sorted(group_series(rows).items()):
        if lineage is not None and lin != lineage:
            continue
        vals = [(r.get("metrics") or {}).get("value") for r in series]
        vals = [v for v in vals if isinstance(v, (int, float))]
        if not vals:
            continue
        unit = ""
        rec = series[-1].get("record") or {}
        if rec.get("unit"):
            unit = f" {rec['unit']}"
        tail = " ".join(fmt(v) for v in vals[-last:])
        out.append(f"{metric} [{lin}] shape={sig[:8]} n={len(vals)}: "
                   f"{tail} ->{fmt(vals[-1])}{unit}")
    return out


def verdict_lines(verdicts) -> list[str]:
    out = []
    for v in verdicts:
        flag = {"regressed": "FAIL", "improved": "good",
                "no-baseline": "warm", "stable": "ok  "}.get(v.status,
                                                            "????")
        extra = ""
        if v.baseline_median is not None:
            extra = (f" value={fmt(v.value)} baseline={fmt(v.baseline_median)}"
                     f" delta={fmt(v.delta)}"
                     f" band=±{fmt(v.threshold)} (n={v.baseline_n})")
        elif v.value is not None:
            extra = f" value={fmt(v.value)} (n={v.baseline_n}, warming up)"
        sev = f" severity={v.severity}" if v.status == "regressed" else ""
        out.append(f"[{flag}] {v.metric}/{v.key} [{v.lineage}] "
                   f"{v.status}{sev}{extra}")
    return out


def markdown_report(rows: list[dict], verdicts, stats: dict | None = None,
                    title: str = "Perf trajectory") -> str:
    lines = [f"# {title}", ""]
    if stats:
        lines.append(
            f"{stats.get('rows', 0)} rows "
            f"({stats.get('dropped_rows', 0)} dropped) across "
            f"{stats.get('files', 0)} files; lineages: "
            + (", ".join(f"{k}={v}" for k, v in
                         sorted(stats.get("lineages", {}).items()))
               or "none"))
        lines.append("")
    lines += ["## Trajectories (headline `value`, oldest -> newest)", ""]
    lines.append("| metric | lineage | shape | n | recent values | latest |")
    lines.append("|---|---|---|---|---|---|")
    for (metric, lin, sig), series in sorted(group_series(rows).items()):
        vals = [(r.get("metrics") or {}).get("value") for r in series]
        vals = [v for v in vals if isinstance(v, (int, float))]
        if not vals:
            continue
        lines.append(f"| `{metric}` | {lin} | `{sig[:8]}` | {len(vals)} | "
                     f"{' '.join(fmt(v) for v in vals[-8:])} | "
                     f"{fmt(vals[-1])} |")
    lines += ["", "## Verdicts (latest run)", ""]
    if verdicts:
        lines.append("| metric/key | lineage | status | severity | value |"
                     " baseline | delta | band |")
        lines.append("|---|---|---|---|---|---|---|---|")
        for v in verdicts:
            lines.append(
                f"| `{v.metric}/{v.key}` | {v.lineage} | {v.status} "
                f"| {v.severity} | {fmt(v.value)} "
                f"| {fmt(v.baseline_median)} | {fmt(v.delta)} "
                f"| ±{fmt(v.threshold)} |")
    else:
        lines.append("_no verdicts (empty run or store)_")
    lines.append("")
    return "\n".join(lines)


def mode_summary_table(results: dict[str, dict],
                       verdicts=None) -> str:
    """bench --all's final table: one line per mode — mode, headline
    metric value, producing backend, gate verdict. Text, to stderr-able
    width; the JSON stays the machine artifact."""
    gate: dict[str, str] = {}
    for v in verdicts or []:
        if v.key != "value":
            continue
        prev = gate.get(v.metric)
        order = {"regressed": 3, "no-baseline": 2, "improved": 1,
                 "stable": 0}
        if prev is None or order.get(v.status, 0) > order.get(prev, 0):
            gate[v.metric] = v.status
    rows = []
    for metric in sorted(results):
        if metric == "bench_all_combined":
            continue
        rec = results[metric]
        value, unit = rec.get("value"), rec.get("unit", "")
        headline = f"{fmt(value)} {unit}".strip() if value is not None \
            else "null"
        rows.append((str(rec.get("mode") or "full"), metric, headline,
                     str(rec.get("backend") or "?"),
                     gate.get(metric, "-")))
    widths = [max([len(h)] + [len(r[i]) for r in rows])
              for i, h in enumerate(("mode", "metric", "headline",
                                     "backend", "gate"))]
    header = ("mode", "metric", "headline", "backend", "gate")
    fmt_row = "  ".join(f"{{:<{w}}}" for w in widths)
    out = [fmt_row.format(*header), fmt_row.format(*("-" * w
                                                     for w in widths))]
    out += [fmt_row.format(*r) for r in rows]
    return "\n".join(out)

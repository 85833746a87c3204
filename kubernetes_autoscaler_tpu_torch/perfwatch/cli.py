"""`python -m kubernetes_autoscaler_tpu_torch.perfwatch` — the operator surface.

  log     append bench JSON lines (files or stdin) to a history store
  check   judge a run against its lineage baselines; print every verdict
          (including observe-class context); always exits 0
  report  render the markdown trajectory + verdict report
  gate    the CI teeth: judge the newest run, write triage bundles for
          confirmed regressions, exit 2 when any gating verdict
          regressed (0 in --advisory mode, which still writes the
          report — the cpu-floor lineage runs advisory in tier1 until
          enough TPU rows bank to make the band meaningful)
  seed    migrate the orphaned BENCH_r0*.json / MULTICHIP_r0*.json
          round-evidence files into the store as the seed lineage

Store-level failures (tamper, unreadable files) exit 3 — distinct from
exit 2 (regression) so CI can tell "the build got slower" from "the
history is broken".
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

from kubernetes_autoscaler_tpu_torch.perfwatch.detect import (
    RegressionDetector,
    gating_regressions,
)
from kubernetes_autoscaler_tpu_torch.perfwatch.history import (
    HistoryTamperError,
    PerfHistory,
    git_commit,
)
from kubernetes_autoscaler_tpu_torch.perfwatch.report import (
    markdown_report,
    trajectory_lines,
    verdict_lines,
)
from kubernetes_autoscaler_tpu_torch.perfwatch.triage import (
    build_bundle,
    write_bundle,
)

_TS_RE = re.compile(r"\d{4}-\d{2}-\d{2}[ T]\d{2}:\d{2}:\d{2}")


def _add_store(sp) -> None:
    sp.add_argument("--history", required=True, metavar="DIR",
                    help="history store directory")
    sp.add_argument("--max-mb", type=float, default=16.0)
    sp.add_argument("--keep-files", type=int, default=8)


def _add_detect(sp) -> None:
    sp.add_argument("--run", default="",
                    help="run id to judge (default: newest in store)")
    sp.add_argument("--lineage", default="",
                    help="restrict judging to one lineage bucket "
                         "(e.g. cpu-floor)")
    sp.add_argument("--min-samples", type=int, default=3)
    sp.add_argument("--window", type=int, default=12)
    sp.add_argument("--k-mad", type=float, default=4.0)


def _open(args) -> PerfHistory:
    return PerfHistory(args.history, max_mb=args.max_mb,
                       keep_files=args.keep_files)


def _verdicts(hist: PerfHistory, args, include_observe: bool):
    rows = hist.load()
    lineage = args.lineage or None
    run = args.run or hist.last_run_id(lineage=lineage)
    det = RegressionDetector(min_samples=args.min_samples,
                             window=args.window, k_mad=args.k_mad,
                             include_observe=include_observe)
    return rows, run, det, det.check_run(rows, run, lineage=lineage)


# ---- subcommands ----

def cmd_log(args) -> int:
    hist = _open(args)
    run_id = args.run_id or os.environ.get("KA_BENCH_RUN_ID", "")
    commit = args.commit if args.commit is not None else git_commit()
    sources = args.files or ["-"]
    appended = 0
    for src in sources:
        fh = sys.stdin if src == "-" else open(src, encoding="utf-8")
        try:
            for line in fh:
                line = line.strip()
                if not line.startswith("{"):
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(obj, dict) or not obj.get("metric") \
                        or obj["metric"] in ("bench_all_combined",
                                             "perfwatch_log"):
                    continue
                hist.append_bench_record(obj, run_id=run_id, commit=commit,
                                         ts=args.ts)
                appended += 1
        finally:
            if fh is not sys.stdin:
                fh.close()
    print(f"[perfwatch] appended {appended} rows to {hist.root} "
          f"(run={run_id or '<from records>'})")
    return 0


def cmd_check(args) -> int:
    hist = _open(args)
    rows, run, _, verdicts = _verdicts(hist, args, include_observe=True)
    print(f"[perfwatch] store {hist.root}: {len(rows)} rows; "
          f"judging run={run or '<none>'}")
    for line in trajectory_lines(rows, lineage=args.lineage or None):
        print("  " + line)
    for line in verdict_lines(verdicts):
        print(line)
    regressed = gating_regressions(verdicts)
    print(f"[perfwatch] {len(verdicts)} verdicts, "
          f"{len(regressed)} gating regressions")
    return 0


def cmd_report(args) -> int:
    hist = _open(args)
    rows, run, _, verdicts = _verdicts(hist, args, include_observe=False)
    md = markdown_report(rows, verdicts, stats=hist.stats(),
                         title=f"Perf trajectory — run {run or 'n/a'}")
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(md)
        print(f"[perfwatch] report -> {args.out}")
    else:
        print(md)
    return 0


def cmd_gate(args) -> int:
    hist = _open(args)
    rows, run, det, verdicts = _verdicts(hist, args, include_observe=False)
    if not run:
        print("[perfwatch] gate: no judged run in store "
              "(empty or all dropped) — nothing to gate")
        return 0
    for line in verdict_lines(verdicts):
        print(line)
    regressed = gating_regressions(verdicts)
    bundles = []
    if regressed and args.bundle_dir:
        by_id = {(r.get("run"), r.get("metric"), r.get("shape_sig")): r
                 for r in rows if not r.get("dropped")}
        for v in regressed:
            row = by_id.get((v.run, v.metric, v.shape_sig))
            if row is None:
                continue
            path = write_bundle(
                build_bundle(v, row, det.baselines_for(rows, row)),
                args.bundle_dir)
            if path:
                bundles.append(path)
                print(f"[perfwatch] triage bundle -> {path}")
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            f.write(markdown_report(rows, verdicts, stats=hist.stats(),
                                    title=f"Perf gate — run {run}"))
    if regressed:
        print(f"[perfwatch] gate: {len(regressed)} confirmed "
              f"regression(s) in run {run}"
              + (f" ({len(bundles)} bundle(s))" if bundles else ""))
        return 0 if args.advisory else 2
    print(f"[perfwatch] gate: run {run} clean "
          f"({len(verdicts)} gating verdicts, 0 regressed)")
    return 0


# ---- seed migration ----

def _seed_bench_file(hist: PerfHistory, path: str, default_metric: str,
                     ts_by_round: dict[int, float]) -> int:
    with open(path, encoding="utf-8") as f:
        o = json.load(f)
    n = int(o.get("n", 0))
    tail = o.get("tail", "") or ""
    stamps = _TS_RE.findall(tail)
    ts = (time.mktime(time.strptime(stamps[-1], "%Y-%m-%d %H:%M:%S"))
          if stamps else ts_by_round.get(n) or os.path.getmtime(path))
    ts_by_round.setdefault(n, ts)
    parsed = o.get("parsed")
    if not isinstance(parsed, dict):
        # pre-never-null round: the process died before emitting any JSON
        parsed = {"metric": default_metric, "value": None, "unit": "ms",
                  "error": "round crashed before emitting a record "
                           "(pre-never-null era)"}
    rec = dict(parsed)
    if rec.get("value") is not None and not rec.get("backend"):
        # r02-era records predate the provenance field; a measured
        # full-shape headline from those rounds is the real-TPU number
        rec["backend"] = "tpu"
    hist.append_bench_record(
        rec, run_id=f"seed-{os.path.basename(path).split('.')[0]}",
        commit="", ts=ts,
        fingerprint={"platform": "seed-evidence", "jax": "", "pack": ""},
        notes=f"migrated from {os.path.basename(path)} (rc={o.get('rc')})")
    return 1


def _seed_multichip_file(hist: PerfHistory, path: str,
                         ts_by_round: dict[int, float]) -> int:
    with open(path, encoding="utf-8") as f:
        o = json.load(f)
    n = int(re.search(r"r(\d+)", os.path.basename(path)).group(1)) \
        if re.search(r"r(\d+)", os.path.basename(path)) else 0
    # the dryrun rode the same round as BENCH_r0N — reuse its stamp
    ts = ts_by_round.get(n) or os.path.getmtime(path)
    rec = {
        "metric": "multichip_dryrun",
        "value": (1.0 if o.get("ok") else None),
        "unit": "ok",
        # its own lineage bucket: a virtual-mesh dryrun is neither tpu
        # evidence nor a cpu floor measurement, and must baseline neither
        "backend": f"dryrun-{int(o.get('n_devices', 0))}dev",
        "n_devices": int(o.get("n_devices", 0)),
        "rc": int(o.get("rc", 0)),
    }
    if o.get("skipped"):
        rec["value"] = None
        rec["error"] = "dryrun skipped"
    hist.append_bench_record(
        rec, run_id=f"seed-{os.path.basename(path).split('.')[0]}",
        commit="", ts=ts,
        fingerprint={"platform": "seed-evidence", "jax": "", "pack": ""},
        notes=f"migrated from {os.path.basename(path)}")
    return 1


def cmd_seed(args) -> int:
    hist = _open(args)
    ts_by_round: dict[int, float] = {}
    bench = sorted(p for p in args.files
                   if os.path.basename(p).startswith("BENCH_"))
    multi = sorted(p for p in args.files
                   if os.path.basename(p).startswith("MULTICHIP_"))
    other = [p for p in args.files if p not in bench and p not in multi]
    if other:
        print(f"[perfwatch] seed: skipping unrecognized files: {other}",
              file=sys.stderr)
    appended = 0
    for p in bench:
        appended += _seed_bench_file(hist, p, args.default_metric,
                                     ts_by_round)
    for p in multi:
        appended += _seed_multichip_file(hist, p, ts_by_round)
    st = hist.stats()
    print(f"[perfwatch] seeded {appended} rows "
          f"({st['dropped_rows']} dropped) into {hist.root}; "
          f"lineages: {st['lineages']}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kubernetes_autoscaler_tpu_torch.perfwatch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("log", help="append bench JSON lines to the store")
    _add_store(sp)
    sp.add_argument("files", nargs="*",
                    help="files of bench JSON lines ('-' or none = stdin)")
    sp.add_argument("--run-id", default="")
    sp.add_argument("--commit", default=None)
    sp.add_argument("--ts", type=float, default=None)
    sp.set_defaults(fn=cmd_log)

    sp = sub.add_parser("check", help="judge + print all verdicts (exit 0)")
    _add_store(sp)
    _add_detect(sp)
    sp.set_defaults(fn=cmd_check)

    sp = sub.add_parser("report", help="markdown trajectory report")
    _add_store(sp)
    _add_detect(sp)
    sp.add_argument("--out", default="", help="write to file, not stdout")
    sp.set_defaults(fn=cmd_report)

    sp = sub.add_parser("gate",
                        help="exit 2 on confirmed regressions "
                             "(0 with --advisory)")
    _add_store(sp)
    _add_detect(sp)
    sp.add_argument("--advisory", action="store_true",
                    help="report-only: never exit nonzero on regressions")
    sp.add_argument("--bundle-dir", default="",
                    help="write a triage bundle per confirmed regression")
    sp.add_argument("--report", default="",
                    help="also write the markdown report here")
    sp.set_defaults(fn=cmd_gate)

    sp = sub.add_parser("seed",
                        help="migrate BENCH_r0*/MULTICHIP_r0* round "
                             "evidence into the store")
    _add_store(sp)
    sp.add_argument("files", nargs="+")
    sp.add_argument("--default-metric",
                    default="scaleup_sim_p50_ms_50kpods_5knodes_20ng",
                    help="metric for rounds that died before emitting JSON")
    sp.set_defaults(fn=cmd_seed)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except HistoryTamperError as e:
        print(f"[perfwatch] HISTORY TAMPER: {e}", file=sys.stderr)
        return 3
    except OSError as e:
        print(f"[perfwatch] store error: {e}", file=sys.stderr)
        return 3


if __name__ == "__main__":
    sys.exit(main())

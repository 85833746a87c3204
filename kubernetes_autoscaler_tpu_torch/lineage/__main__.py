"""`python -m kubernetes_autoscaler_tpu_torch.lineage` — query a journal dir's
decision lineage offline, or tail a live one.

    lineage DIR why node/worker-3
    lineage DIR timeline --loops 10..20
    lineage DIR diff --loop 14
    lineage DIR runs                     # chain heads in a multi-run dir
    lineage DIR stats
    lineage DIR --run ab12 why ...       # pin a run by head-digest prefix
    lineage DIR --follow [--until-loop N] [--max-wait S] timeline

Exit codes: 0 on success (for `why`, the object must be found; for
--follow --until-loop, the loop must arrive), 1 on not-found/timeout,
2 on usage errors. JSON output with --json on every verb."""

from __future__ import annotations

import argparse
import json
import sys

from kubernetes_autoscaler_tpu_torch.lineage.index import LineageIndex
from kubernetes_autoscaler_tpu_torch.lineage import query as q


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m kubernetes_autoscaler_tpu_torch.lineage",
        description="Query decision lineage over a journal directory.")
    p.add_argument("journal_dir", help="journal directory to index")
    p.add_argument("--run", default=None, metavar="HEAD",
                   help="select a run by chain-head digest prefix "
                        "(default: latest run)")
    p.add_argument("--artifact-dir", action="append", default=[],
                   metavar="DIR",
                   help="extra artifact dir(s) beyond those the journal "
                        "meta names")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    p.add_argument("--no-verify-seals", action="store_true",
                   help="skip record seal verification while scanning")
    p.add_argument("--follow", action="store_true",
                   help="keep tailing the dir after the first render")
    p.add_argument("--poll", type=float, default=0.25,
                   help="--follow poll interval seconds")
    p.add_argument("--max-wait", type=float, default=None,
                   help="--follow gives up after this many seconds")
    p.add_argument("--until-loop", type=int, default=None,
                   help="--follow exits 0 once this loop is indexed")
    sub = p.add_subparsers(dest="verb")
    w = sub.add_parser("why", help="an object's causal chain")
    w.add_argument("object", help="KIND/NAME (node/…, pod-group/…, "
                                  "nodegroup/…); bare names are pod-groups")
    t = sub.add_parser("timeline", help="per-loop decision summary")
    t.add_argument("--loops", default=None, metavar="A..B",
                   help="loop range (A.., ..B, A..B, or K)")
    d = sub.add_parser("diff", help="object-level delta across one loop")
    d.add_argument("--loop", type=int, required=True)
    sub.add_parser("runs", help="list chain heads found in the dir")
    sub.add_parser("stats", help="index stats + scan problems")
    return p


def _render(args, idx: LineageIndex) -> str:
    if args.verb == "why":
        kind, name = q.parse_object(args.object)
        return q.render_why(idx.why(kind, name), as_json=args.json)
    if args.verb == "timeline":
        lo = hi = None
        if args.loops:
            lo, hi = q.parse_loops(args.loops)
        return q.render_timeline(idx.timeline(lo, hi), as_json=args.json)
    if args.verb == "diff":
        return q.render_diff(idx.diff(args.loop), as_json=args.json)
    if args.verb == "runs":
        return q.render_runs(idx.runs, idx.run_head, as_json=args.json)
    payload = {"stats": idx.stats(), "problems": list(idx.problems),
               "run": idx.run_head,
               "artifactDirs": idx.artifact_dirs()}
    if args.json:
        return json.dumps(payload, indent=2, sort_keys=True)
    lines = [f"run {idx.run_head[:16] or '(none)'}"]
    for k, v in sorted(payload["stats"].items()):
        lines.append(f"  {k}: {v}")
    for pr in payload["problems"]:
        lines.append(f"  problem: {json.dumps(pr, sort_keys=True)}")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.verb is None:
        args.verb = "stats"
    try:
        idx = LineageIndex(args.journal_dir, run=args.run,
                           artifact_dirs=args.artifact_dir,
                           verify_seals=not args.no_verify_seals)
    except OSError as exc:
        print(f"lineage: cannot open {args.journal_dir}: {exc}",
              file=sys.stderr)
        return 2
    print(_render(args, idx))
    if args.follow:
        def on_new(n, index):
            sys.stdout.write(f"\n--- +{n} records"
                             f" (loop {index.last_loop}) ---\n")
            sys.stdout.write(_render(args, index) + "\n")
            sys.stdout.flush()
        arrived = q.follow(idx, on_new, poll_s=args.poll,
                           max_wait_s=args.max_wait,
                           until_loop=args.until_loop)
        if args.until_loop is not None:
            return 0 if arrived else 1
        return 0
    if args.verb == "why":
        kind, name = q.parse_object(args.object)
        return 0 if idx.why(kind, name)["found"] else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CLI: python -m kubernetes_autoscaler_tpu_torch.replay <journal> [--loop K]
[--device cpu|cuda] [--diff] [--out PATH]

Replays a flight journal recorded by --journal-dir (StaticAutoscaler)
or the tests, and prints the drift report as JSON.
Exit codes: 0 zero drift, 2 drift detected, 1 structural journal error.
The replay runs on the CUDA device unless `--device cpu` is given, and
raises without one.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kubernetes_autoscaler_tpu_torch.replay",
        description="Replay a deterministic flight journal and report drift")
    ap.add_argument("journal", help="journal directory or a single "
                                    "journal-*.jsonl file")
    ap.add_argument("--loop", type=int, default=None,
                    help="replay up to (and report through) this loop index "
                         "(earlier loops still execute — cross-loop state)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="the device to replay on (default: cuda) — the "
                         "cross-device divergence oracle (record on one "
                         "device, replay on the other)")
    ap.add_argument("--diff", action="store_true",
                    help="include the reason-plane (uint16 bits per "
                         "pod-group × node) localization even for clean "
                         "loops")
    ap.add_argument("--out", default="",
                    help="also write the report JSON to this path")
    args = ap.parse_args(argv)

    from kubernetes_autoscaler_tpu_torch.replay.harness import (
        JournalError,
        replay_journal,
    )

    try:
        report = replay_journal(args.journal, upto=args.loop, diff=args.diff,
                                device=args.device)
    except JournalError as e:
        print(json.dumps({"error": str(e)}), file=sys.stderr)
        return 1
    doc = json.dumps(report, indent=2)
    print(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
    return 0 if report["zeroDrift"] else 2


if __name__ == "__main__":
    sys.exit(main())

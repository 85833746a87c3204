"""`python -m kubernetes_autoscaler_tpu_torch.whatif` — the what-if CLI.

Branch from a journal cursor (--journal/--upto) or a seeded synthetic world
(default), fan out variant lanes, run the multiverse step and optionally a
time-compressed rollout, and print the JSON report (docs/WHATIF.md).
Everything runs on the CUDA device unless `--device cpu` is given, and
raises without one.

Examples:
  python -m kubernetes_autoscaler_tpu_torch.whatif --synthetic --rollout 32 \\
      --workload diurnal --variants '[{"price_scale": 2.0}, \\
      {"threshold": 0.8, "name": "aggressive-drain"}]'
  python -m kubernetes_autoscaler_tpu_torch.whatif --journal /var/log/ka.journal \\
      --upto 120 --variants '[{"max_new_cap": 4}]'
  python -m kubernetes_autoscaler_tpu_torch.whatif --device cpu --rollout 4
"""

from __future__ import annotations

import argparse
import json
import sys


def _parse_args(argv):
    p = argparse.ArgumentParser(
        prog="python -m kubernetes_autoscaler_tpu_torch.whatif",
        description="Counterfactual multiverse: batched what-if evaluation "
                    "over a branched autoscaler world.")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--journal", help="branch from this journal file")
    src.add_argument("--synthetic", action="store_true",
                     help="branch from a seeded synthetic world (default)")
    p.add_argument("--upto", type=int, default=None,
                   help="journal loop cursor to branch at (default: last)")
    p.add_argument("--variants", default="[]",
                   help="JSON list of variant dicts (price_scale, "
                        "max_new_cap, threshold, fail_nodes, pending_scale,"
                        " name); lane 0 null hypothesis is always prepended")
    p.add_argument("--rollout", type=int, default=0, metavar="T",
                   help="time-compressed rollout over T simulated loops "
                        "(0 = single multiverse step)")
    p.add_argument("--workload", default="quiet",
                   help="rollout workload kind: quiet|diurnal|bursty|spot")
    p.add_argument("--workload-seed", type=int, default=0)
    p.add_argument("--base-rate", type=float, default=2.0)
    p.add_argument("--strategy", default="least-waste")
    p.add_argument("--seed", type=int, default=0,
                   help="synthetic world seed")
    p.add_argument("--nodes", type=int, default=8)
    p.add_argument("--pending", type=int, default=6)
    p.add_argument("--out", default="-",
                   help="report path ('-' = stdout)")
    p.add_argument("--device", choices=("cpu", "cuda"), default=None,
                   help="the device the branch world and the lanes run on "
                        "(default: cuda)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])

    from kubernetes_autoscaler_tpu_torch.whatif import kernel, report, variants
    from kubernetes_autoscaler_tpu_torch.whatif.generator import (
        WorkloadSpec,
        generate_workload,
        lane_workloads,
    )

    specs = [variants.VariantSpec.from_dict(d)
             for d in json.loads(args.variants)]
    if args.journal:
        branch = variants.branch_from_journal(args.journal, upto=args.upto,
                                              device=args.device)
    else:
        from kubernetes_autoscaler_tpu_torch.whatif.synthetic import (
            synthetic_branch,
        )

        branch, _a = synthetic_branch(n_nodes=args.nodes,
                                      n_pending=args.pending,
                                      seed=args.seed, device=args.device)
    from kubernetes_autoscaler_tpu_torch.sidecar.shapes import rung

    want = len(specs) + (0 if specs and specs[0].is_null() else 1)
    lanes = variants.build_lanes(branch, specs, pad_to=rung(want, 4))
    st = lanes.statics
    kw = dict(dims=st["dims"], max_new_nodes=st["max_new_nodes"],
              max_pods_per_node=st["max_pods_per_node"],
              strategy=args.strategy)

    decision, summary = kernel.multiverse_step(
        lanes.nodes, lanes.specs, lanes.scheduled, lanes.groups,
        lanes.limit_cap, **kw)
    traj = wl = None
    if args.rollout > 0:
        wl = WorkloadSpec(kind=args.workload, seed=args.workload_seed,
                          base_rate=args.base_rate)
        g = int(lanes.specs.count.shape[1])
        n = int(lanes.nodes.valid.shape[1])
        adds, fails = generate_workload(wl, args.rollout, g, n)
        adds_b, fails_b = lane_workloads(lanes.variants, adds, fails)
        traj = kernel.rollout_multiverse(
            lanes.nodes, lanes.specs, lanes.scheduled, lanes.groups,
            lanes.limit_cap, lanes.thresholds, adds_b, fails_b, **kw)

    rep = report.build_report(lanes, summary=summary, decision=decision,
                              traj=traj, workload=wl)
    text = json.dumps(rep, indent=2, sort_keys=True)
    if args.out == "-":
        print(text)
    else:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"whatif report: {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The control of the `correct` check: the reference in the program's place,
its float arithmetic in bfloat16 (the next precision below the float32 that
the configurations state), judged as the benchmark judges the program.

    python3 -m portbench.control --workload <cell> --seeds <n,n,...>

For each seed, every variant of the cell is decided twice by the reference
(reference/decide.py): as the program is held to it, and in bfloat16 (the
control: the first-fit decreasing size score, utilization, waste, price and
the helped requests). It prints, a line a seed, the compared numbers of the
control against the reference, as judge.py computes them for a run, beside
their limits; the control has to fail at least one. The benchmark's runs do
not run this; it is how the limits' upper readings were taken (see PERF.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import judge, spec, world
from portbench.reference import decide as ref


def control_numbers(cfg: dict, traffic: dict, seed: int) -> dict:
    """{exact_mismatches, float_gap} of the bfloat16 control over every
    variant of `seed`."""
    numbers = {"exact_mismatches": 0, "float_gap": 0.0}
    for v in world.variants(cfg, traffic, seed):
        want, _ = ref.decide(cfg, traffic, v)
        got, _ = ref.decide(cfg, traffic, v, float_dtype=torch.bfloat16)
        m, g = judge.against(got, want)
        numbers["exact_mismatches"] += m
        numbers["float_gap"] = max(numbers["float_gap"], g)
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.load("configs", cell["config"])
    traffic = spec.load("traffic", cell["traffic"])
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        numbers = control_numbers(cfg, traffic, seed)
        ok = judge.verdict(numbers)
        failed_all &= not ok
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": ok, "seconds": time.time() - t0,
                          "limits": judge.report(numbers)}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())

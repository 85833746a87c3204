#!/usr/bin/env python3
"""Row S's scatter (`csrc/histogram.cu`) by pass, on the card.

    python3 tools/torch_hist_passes.py [--reps N]

Runs `histogram_kernel.scatter_add_ordered` on `hist_cases`' history feed
at the recommender's shape (20,000 aggregates x 192 samples into 33,790
rows), its RunOnce feed and its skewed batch, N times each under
torch.profiler, and prints one JSON line a case: the device time a call of
each kernel the entry launches (the memset, `count_kernel`, the
`scan_kernel`s, each `sort_pass_kernel` instance, `fold_kernel`), the
sum, and the card line.
Each call is first checked byte-equal to the plain version on the CPU.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def kernel_name(key: str) -> str:
    """A short name for a profiler key: the kernel's own name, with the
    template arguments of a sort pass (first, last)."""
    for name in ("count_kernel", "scan_kernel", "fold_kernel",
                 "sort_pass_kernel"):
        if name in key:
            if name == "sort_pass_kernel":
                args = key[key.index("<") + 1:key.index(">")] \
                    if "<" in key else key
                return f"{name}<{args}>"
            return name
    return "memset" if "memset" in key.lower() else key[:60]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_hist_passes: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from kubernetes_autoscaler_tpu_torch.ops.kernels import (
        hist_cases,
        histogram_kernel,
    )

    card = cs.card_line()
    cases = {
        "history A=33790 n=3840000": hist_cases.history_case(20_000, 192,
                                                              33_790),
        "RunOnce A=33790 n=100000": hist_cases.CASES["run_once"](),
        "skewed A=500 n=60000": hist_cases.CASES["skewed"](),
    }
    for name, args in cases.items():
        cs.check_hist(name, args, histogram_kernel.scatter_add_ordered,
                      histogram_kernel.scatter_add_ordered_plain)
        dev = [x.to("cuda") for x in args]
        for _ in range(3):
            histogram_kernel.scatter_add_ordered(*dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(a.reps):
                histogram_kernel.scatter_add_ordered(*dev)
            torch.cuda.synchronize()
        per = {}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = ev.cuda_time_total
            if t <= 0:
                continue
            k = kernel_name(ev.key)
            per[k] = per.get(k, 0.0) + t / 1e3 / a.reps
        print(json.dumps({"case": name, "reps": a.reps,
                          "device_ms_a_call": per,
                          "sum_ms": sum(per.values())}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The VPA phases of chip_smoke.py alone, on the card.

    python3 tools/torch_vpa_run.py

Builds the histogram scatter kernel (`csrc/histogram.cu`, with nvcc's
resource report), holds it to its plain version on every case of
`ops/kernels/hist_cases.CASES`, then runs `chip_smoke.vpa_phase` ([vpa]:
the recommender at the upstream defaults over chip_smoke.VPA_OBJECTS VPA
objects) and `chip_smoke.vpa_cpu_card_phase` ([vpa-cpu-card])
with the same code and sizes as chip_smoke.py. Prints what those phases
print, then the card line and the scatter's kernels-line entry as one JSON
line. Needs a card; exits 1 without one.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_vpa_run: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from kubernetes_autoscaler_tpu_torch.ops.kernels import (
        build,
        hist_cases,
        histogram_kernel,
    )

    card = c.card_line()
    c.log(card)
    t0 = time.perf_counter()
    libs = build.build([histogram_kernel.SOURCE])
    c.log(f"[build] {libs[histogram_kernel.SOURCE].name} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, regs, spills in c.ptxas_report(
            libs[histogram_kernel.SOURCE].with_suffix(".log")):
        c.log(f"[build] {histogram_kernel.SOURCE} {name}: {regs} registers, "
              f"{spills}")
    kernel = histogram_kernel.scatter_add_ordered
    plain = histogram_kernel.scatter_add_ordered_plain
    err = 0.0
    for name, case in hist_cases.CASES.items():
        err = max(err, c.check_hist(name, case(), kernel, plain))
    run, launches, fields, e = c.vpa_phase(card, kernel, plain)
    c.vpa_cpu_card_phase(card, run)
    print(card, flush=True)
    print(json.dumps({"name": "scatter_add_ordered", "launches": launches,
                      "max_abs_err": max(err, e), **fields}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

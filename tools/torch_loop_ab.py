#!/usr/bin/env python3
"""`[loop]` (or another phase) of chip_smoke.py on the port of each given tree, in turns.

    python3 tools/torch_loop_ab.py [--phase loop|main|constrained|loop-constrained]
                                   [--log-dir DIR] TREE [TREE ...]

For each TREE (a checkout of the repo, e.g. the parent commit unpacked with
`git archive` into a directory .gitignore lists), in the order given, a fresh
process imports that tree's `kubernetes_autoscaler_tpu_torch`, builds its K1
and runs THIS checkout's `chip_smoke.loop_phase` on the card: the same world,
churn script and clock for every tree, so two trees compare within one call
(give them as parent, change, change, parent). Prints one JSON line per run
(the tree, the timed loops' ms, p50 and p90, the card) and needs a card.
With `--phase main` each run is `chip_smoke.main_phase` instead (the fused
step on the main world, 100 steps, then one step under torch.profiler; the
line holds the step p50 and p90, the scale_down phase's p50 and p90, the
device kernels a step, the busy share and the drain kernel's launches that
the phase prints). With `--phase constrained` each run is the constrained
fused step (`chip_smoke.constrained_steps` on `constrained_world`: step,
filter-phase and scale_down-phase p50/p90, the wave placer's and the drain
kernel's launches a step, then one step under torch.profiler: device
kernels a step and the busy share of the step p50); with `--phase loop-constrained`
it is `chip_smoke.loop_constrained_phase` (loop ms, p50, p90, each loop
phase's share of the loops' time). `--log-dir` keeps each run's whole
output there (`PHASE-I.log`).
"""

from __future__ import annotations

import os
import subprocess
import sys

CHILD = """
import importlib.util, json, os, sys
tree, smoke = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("chip_smoke_ab", smoke)
c = importlib.util.module_from_spec(spec)
spec.loader.exec_module(c)
from kubernetes_autoscaler_tpu_torch.models.cluster_state import Dims
from kubernetes_autoscaler_tpu_torch.ops.kernels import build, pack_kernel
if not os.path.abspath(pack_kernel.__file__).startswith(tree):
    raise SystemExit(f"imported {pack_kernel.__file__}, not {tree}'s port")
build.build([pack_kernel.SOURCE])
card = c.card_line()
k1, k1_plain = pack_kernel.pack_groups_batched, pack_kernel.pack_groups_batched_plain
if sys.argv[3] == "constrained":
    import contextlib, io
    from kubernetes_autoscaler_tpu_torch.ops.kernels import drain_kernel
    enc, groups, step = c.constrained_world(Dims())
    step()
    c.torch.cuda.synchronize()
    con0, d0 = c.con_launches(), drain_kernel.launch.launches
    ms, phase_ms, _, _ = c.constrained_steps(card, step)
    con1, d1 = c.con_launches(), drain_kernel.launch.launches
    with contextlib.redirect_stdout(io.StringIO()):
        kernels, busy = c.profile_step(step, c.pct(ms, 50), None, tag="[constrained]")
    f, down = phase_ms["filter"], phase_ms["scale_down"]
    print(json.dumps({"tree": tree, "phase": "constrained", "ms": ms,
                      "p50": c.pct(ms, 50), "p90": c.pct(ms, 90),
                      "filter_p50": c.pct(f, 50), "filter_p90": c.pct(f, 90),
                      "scale_down_p50": c.pct(down, 50),
                      "scale_down_p90": c.pct(down, 90),
                      "con_launches_per_step": (con1 - con0) / len(ms),
                      "drain_launches_per_step": (d1 - d0) / len(ms),
                      "kernels": kernels, "busy": busy / c.pct(ms, 50),
                      "card": card}))
elif sys.argv[3] == "loop-constrained":
    ms, shares = c.loop_constrained_phase(card)
    print(json.dumps({"tree": tree, "phase": "loop-constrained", "ms": ms,
                      "p50": c.pct(ms, 50), "p90": c.pct(ms, 90),
                      "shares": shares, "card": card}))
elif sys.argv[3] == "main":
    import argparse, contextlib, io, re, tempfile
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        c.main_phase(argparse.Namespace(profile=tempfile.mkdtemp()), Dims(), k1, k1_plain)
    text = out.getvalue()
    print(text, file=sys.stderr)
    p50, p90 = map(float, re.search(r"\\[main\\] step ms over \\d+ steps: p50 (\\S+) p90 (\\S+)",
                                    text).groups())
    down50, down90 = map(float, re.search(
        r"\\[main\\] phase scale_down ms \\(CUDA events\\): p50 (\\S+) p90 (\\S+)", text).groups())
    kernels, busy = re.search(r"\\[profile\\] (\\d+) device kernels in one step, \\S+ ms of "
                              r"kernel time; busy share of the unprofiled step p50 (\\S+)",
                              text).groups()
    drain = re.search(r"\\[main\\] drain kernel launches: (\\d+)", text)
    print(json.dumps({"tree": tree, "phase": "main", "p50": p50, "p90": p90,
                      "scale_down_p50": down50, "scale_down_p90": down90,
                      "kernels": int(kernels), "busy": float(busy),
                      "drain_launches": int(drain.group(1)) if drain else None,
                      "card": card}))
else:
    _, _, _, (ms, _), _ = c.loop_phase(card, Dims(), k1, k1_plain)
    print(json.dumps({"tree": tree, "ms": ms, "p50": c.pct(ms, 50),
                      "p90": c.pct(ms, 90), "card": card}))
"""


def main() -> int:
    args = sys.argv[1:]
    phase, log_dir = "loop", None
    while args[:1] in (["--phase"], ["--log-dir"]) and len(args) > 1:
        if args[0] == "--phase":
            phase = args[1]
        else:
            log_dir = args[1]
        args = args[2:]
    trees = [os.path.abspath(t) for t in args]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smoke = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    for i, tree in enumerate(trees):
        r = subprocess.run([sys.executable, "-c", CHILD, tree, smoke, phase],
                           cwd=tree, capture_output=True, text=True,
                           timeout=900)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            with open(os.path.join(log_dir, f"{phase}-{i}.log"), "w") as f:
                f.write(r.stdout + r.stderr)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            return 1
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

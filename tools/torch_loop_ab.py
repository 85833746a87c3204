#!/usr/bin/env python3
"""`[loop]` (or `[main]`) of chip_smoke.py on the port of each given tree, in turns.

    python3 tools/torch_loop_ab.py [--phase loop|main] TREE [TREE ...]

For each TREE (a checkout of the repo, e.g. the parent commit unpacked with
`git archive` into a directory .gitignore lists), in the order given, a fresh
process imports that tree's `kubernetes_autoscaler_tpu_torch`, builds its K1
and runs THIS checkout's `chip_smoke.loop_phase` on the card: the same world,
churn script and clock for every tree, so two trees compare within one call
(give them as parent, change, change, parent). Prints one JSON line per run
(the tree, the timed loops' ms, p50 and p90, the card) and needs a card.
With `--phase main` each run is `chip_smoke.main_phase` instead (the fused
step on the main world, 100 steps; the line holds the step p50 and p90 that
the phase prints).
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
if sys.argv[3] == "main":
    import argparse, contextlib, io, re
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        c.main_phase(argparse.Namespace(profile=None), Dims(), k1, k1_plain)
    p50, p90 = map(float, re.search(r"\\[main\\] step ms over \\d+ steps: p50 (\\S+) p90 (\\S+)",
                                    out.getvalue()).groups())
    print(json.dumps({"tree": tree, "phase": "main", "p50": p50, "p90": p90, "card": card}))
else:
    _, _, _, (ms, _) = c.loop_phase(card, Dims(), k1, k1_plain)
    print(json.dumps({"tree": tree, "ms": ms, "p50": c.pct(ms, 50),
                      "p90": c.pct(ms, 90), "card": card}))
"""


def main() -> int:
    args = sys.argv[1:]
    phase = "loop"
    if args[:1] == ["--phase"] and len(args) > 1:
        phase, args = args[1], args[2:]
    trees = [os.path.abspath(t) for t in args]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smoke = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    for tree in trees:
        r = subprocess.run([sys.executable, "-c", CHILD, tree, smoke, phase],
                           cwd=tree, capture_output=True, text=True,
                           timeout=900)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            return 1
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

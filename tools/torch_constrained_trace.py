#!/usr/bin/env python3
"""Where row C's time goes: the cycles of each step of a wave of
`csrc/constrained.cu` (its wave body, `csrc/waves.cuh` `place_waves`).

    python3 tools/torch_constrained_trace.py [--clusters 4,8,16] [TREE ...]

For each TREE (default: this checkout; e.g. the parent commit unpacked with
`git archive` into a directory .gitignore lists, then this checkout), its
`kubernetes_autoscaler_tpu_torch/csrc/constrained.cu` and the headers
beside it are copied into a temporary directory, a clock64() read by thread
0 of block 0 (lane 0's CTA, rank 0 of its cluster in the cluster design) is
inserted at fixed points of the group loop and of the wave loop, and the
copy is built with the port's nvcc flags. Each mark adds the cycles since
the previous mark to its step and counts its hits. THIS checkout's
`chip_smoke.py` records the constrained world's filter pack (B = 1, G = 64,
N = 5,120; `[constrained]`'s inputs), which each tree's kernel runs, as
the wrapper would launch it (tools/torch_kernel_ab.py's launchers),
checked byte-equal to this checkout's plain version. Prints, per tree, the
device time (chip_smoke.cuda_ms, the stream held), the lane-waves, and each
step's total cycles, hits and cycles a hit; then the SM clock and the card
line. A mark after a barrier or an exchange includes the wait at it; the
marks keep their sums in shared memory and write them out at the kernel's
end. The points are found by the sources' own lines; the tool fails if
one is missing. With `--clusters`, this checkout's kernel, uninstrumented,
is also timed at each cluster size given (forced through its config
entry) on the filter pack and on the options pack (B = 24), each launch
checked byte-equal. Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import torch_kernel_ab as ab  # noqa: E402

# (file, line start after indentation, "before"/"after", step name); each
# step's cycles are those since the previous mark, whichever it was
ONE_CTA = (
    ("constrained.cu", "for (int it = 0; it < G; ++it) {", "after",
     "between groups (one-shot groups, the placed row out)"),
    ("constrained.cu", "const WaveGroup wg{cnt,", "before",
     "group prologue (request codes, zone arrays, a barrier)"),
    ("waves.cuh", "// 1. the zone caps of this wave", "before",
     "wave top (the loop test)"),
    ("waves.cuh", "// 2. fit, feasibility, limit_one;", "before",
     "1 zone caps"),
    ("waves.cuh", "// 3. positive affinity and the hostname-spread", "before",
     "2 fits (R quotients a node, rows from L2) and the minima (barrier)"),
    ("waves.cuh", "// 4. the zone caps, less the exclusive prefix", "before",
     "3 affinity and hostname spread"),
    ("waves.cuh", "// 5. the global first fit in node order", "before",
     "4 zone prefix (2 barriers and the segmented scan's)"),
    ("waves.cuh", "++waves;", "before",
     "5 global first fit (scan barrier), update, placed sum (barrier)"),
    ("waves.cuh", "return waves;", "before", "the lane's exit"),
)
CLUSTER = (
    ("constrained.cu", "for (int it = 0; it < G; ++it) {", "after",
     "between groups (one-shot groups, the placed row out)"),
    ("constrained.cu", "const WaveGroup wg{cnt,", "before",
     "group prologue (request codes, staging, a barrier, the fit cache)"),
    ("waves.cuh", "// 2. each node's fit before the wave's clips", "before",
     "wave top (the last wave's update)"),
    ("waves.cuh", "if (rem <= 0 || done || waves >= max_waves) break;", "after",
     "2 fits from the cache, the minima exchange where one is read"),
    ("waves.cuh", "// 4. the zone caps (spread allowance", "before",
     "3 fit, affinity and hostname spread"),
    ("waves.cuh", "unsigned run = blk.seg_carry(sf, ss);", "after",
     "4a fits-in barrier, zone walk, segmented scan (a barrier)"),
    ("waves.cuh", "blk.zone_sync();", "after",
     "4b zone totals pushed, the zone exchange"),
    ("waves.cuh", "blk.zone_columns(cap_of, fused);", "after",
     "4c spread minimum, zone columns (a barrier)"),
    ("waves.cuh", "// 5. the global first fit in node order", "before",
     "4d caps walk, capped totals, a barrier"),
    ("waves.cuh", "++waves;", "before",
     "5 global first fit (a CTA scan in a fused wave, else an exchange), "
     "update"),
    ("waves.cuh", "return waves;", "before",
     "the lane's exit (a barrier where the last wave had no minima)"),
)
MARKS = 64
# the marks accumulate in shared memory (a mark costs a few shared-memory
# accesses, not a round trip to device memory) and go out at the kernel's end
HEADER = """
__device__ unsigned long long ka_trace[%d];
__device__ unsigned long long ka_hits[%d];
static __shared__ unsigned long long ka_trace_s[%d];
static __shared__ unsigned long long ka_hits_s[%d];
static __shared__ long long ka_last;
#define KA_TRACER (threadIdx.x == 0 && blockIdx.x == 0)
#define KA_START() do { if (KA_TRACER) { for (int i_ = 0; i_ < %d; ++i_) \\
    ka_trace_s[i_] = ka_hits_s[i_] = 0; ka_last = clock64(); } } while (0)
#define KA_MARK(i) do { if (KA_TRACER) { \\
    const long long now_ = clock64(); ka_trace_s[(i)] += now_ - ka_last; ka_hits_s[(i)] += 1; \\
    ka_last = now_; } } while (0)
#define KA_FLUSH() do { if (KA_TRACER) for (int i_ = 0; i_ < %d; ++i_) { \\
    ka_trace[i_] = ka_trace_s[i_]; ka_hits[i_] = ka_hits_s[i_]; } } while (0)
""" % ((MARKS,) * 6)
# where each design's kernel ends (the flush goes after it)
END = {"one_cta": "__syncthreads();  // the next lane reuses the shared arrays",
       "cluster": "if (tid == 0 && rank == 0 && lane_waves > 0) atomicAdd("}
FOOTER = """
extern "C" int ka_trace_reset() {
  static unsigned long long zero[%d];
  cudaError_t e = cudaMemcpyToSymbol(ka_trace, zero, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(ka_hits, zero, sizeof(zero));
  return static_cast<int>(e);
}
extern "C" int ka_trace_read(unsigned long long* cycles, unsigned long long* hits) {
  cudaError_t e = cudaMemcpyFromSymbol(cycles, ka_trace, sizeof(ka_trace));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(hits, ka_hits, sizeof(ka_hits));
  return static_cast<int>(e);
}
""" % MARKS


def instrument(csrc: str, out: str, marks, end: str) -> str:
    """Copy the tree's constrained.cu and headers into `out` with the marks
    inserted (the flush after the line starting `end`); returns the
    instrumented source's path."""
    for header in os.listdir(csrc):
        if header.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, header), out)
    texts = {}
    for name in ("constrained.cu", "waves.cuh"):
        with open(os.path.join(csrc, name)) as f:
            texts[name] = f.read().split("\n")
    for k, (name, anchor, where, _) in enumerate(marks):
        lines = texts[name]
        hits = [i for i, line in enumerate(lines) if line.lstrip().startswith(anchor)]
        if len(hits) != 1:
            raise SystemExit(f"anchor not found once in {name}: {anchor!r}")
        i = hits[0] + (1 if where == "after" else 0)
        lines.insert(i, f"KA_MARK({k});")
    lines = texts["constrained.cu"]
    hits = [i for i, line in enumerate(lines) if line.lstrip().startswith(end)]
    if len(hits) != 1:
        raise SystemExit(f"the kernel's end not found once: {end!r}")
    lines.insert(hits[0] + 1, "KA_FLUSH();")
    waves = "\n".join(texts["waves.cuh"]).replace(
        "namespace ka {", HEADER + "\nnamespace ka {", 1)
    con = "\n".join(texts["constrained.cu"])
    # the first mark's reference point: the group loop's entry
    con = con.replace("  for (int it = 0; it < G; ++it) {",
                      "  KA_START();\n  for (int it = 0; it < G; ++it) {", 1)
    with open(os.path.join(out, "waves.cuh"), "w") as f:
        f.write(waves)
    src = os.path.join(out, "constrained_trace.cu")
    with open(src, "w") as f:
        f.write(con + FOOTER)
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clusters", default="",
                    help="comma-separated cluster sizes at which to time this "
                         "checkout's (uninstrumented) kernel on the same "
                         "inputs, each launch checked byte-equal")
    ap.add_argument("trees", nargs="*")
    a = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = [os.path.abspath(t) for t in a.trees] or [here]
    if not torch.cuda.is_available():
        print("torch_constrained_trace: no CUDA device", file=sys.stderr)
        return 1
    from kubernetes_autoscaler_tpu_torch.ops.kernels import constrained_kernel

    card = cs.card_line()
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, tree in enumerate(dict.fromkeys(trees)):
            csrc = os.path.join(tree, "kubernetes_autoscaler_tpu_torch", "csrc")
            with open(os.path.join(csrc, "waves.cuh")) as f:
                design = "cluster" if "struct Cluster" in f.read() else "one_cta"
            marks = CLUSTER if design == "cluster" else ONE_CTA
            out = os.path.join(tmp, str(i))
            os.makedirs(out)
            src = instrument(csrc, out, marks, END[design])
            libs[tree] = (ab.build_tree(tree, out, ["C"], {"C": src})["C"], marks)
        calls, _ = ab.con_inputs()
        args = calls["filter"]
        wants = {}
        for name, inputs in calls.items():
            res = constrained_kernel.pack_lanes_plain(*inputs)
            wants[name] = (res.free_after, res.placed, res.scheduled)
        want = wants["filter"]

        def check(name, got, want=want):
            torch.cuda.synchronize()
            for k, (g, w) in enumerate(zip(got, want)):
                if not torch.equal(g, w):
                    raise AssertionError(f"{name}: output {k} differs from the "
                                         f"plain version")

        # the filter (one lane) and the options (lane 0 of B traced)
        for name, inputs in calls.items():
            for tree in trees:
                lib, marks = libs[tree]
                counter = torch.zeros((1,), dtype=torch.int64, device=cs.DEVICE)
                fn = ab.con_launcher(lib, counter)
                check(f"{tree} {name}", fn(*inputs), wants[name])
                ms = cs.cuda_ms(lambda fn=fn: fn(*inputs), cs.REPS, hold=True)
                counter.zero_()
                lib.ka_trace_reset()
                fn(*inputs)
                torch.cuda.synchronize()
                cycles = (ctypes.c_ulonglong * MARKS)()
                hits = (ctypes.c_ulonglong * MARKS)()
                rc = lib.ka_trace_read(cycles, hits)
                if rc != 0:
                    raise RuntimeError(f"trace read failed: CUDA error {rc}")
                steps = {s: {"cycles": cycles[k], "hits": hits[k],
                             "per_hit": cycles[k] / hits[k] if hits[k] else None}
                         for k, (_, _, _, s) in enumerate(marks)}
                b, n, _ = inputs[0].shape
                print(json.dumps({
                    "tree": tree, "inputs": f"[constrained] {name} pack B={b} "
                    f"G={inputs[2].shape[0]} N={n} (lane 0 traced)",
                    "device_ms": ms, "lane_waves": int(counter),
                    "kernel_cycles": sum(cycles[:len(marks)]),
                    "steps": steps}), flush=True)
        if a.clusters:
            plain_dir = os.path.join(tmp, "uninstrumented")
            os.makedirs(plain_dir)
            lib = ab.build_tree(here, plain_dir, ["C"])["C"]
            opt = calls["options"]
            res = constrained_kernel.pack_lanes_plain(*opt)
            opt_want = (res.free_after, res.placed, res.scheduled)
            for cluster in (int(c) for c in a.clusters.split(",")):
                fn = ab.con_launcher(lib, cluster=cluster)
                check(f"cluster {cluster}", fn(*args))
                got = fn(*opt)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, opt_want)):
                    raise AssertionError(f"options, cluster {cluster}: differs "
                                         f"from the plain version")
                print(json.dumps({
                    "tree": here, "cluster": cluster,
                    "filter_device_ms": cs.cuda_ms(lambda fn=fn: fn(*args),
                                                   cs.REPS, hold=True),
                    "options_device_ms": cs.cuda_ms(lambda fn=fn: fn(*opt),
                                                    cs.REPS, hold=True)}),
                      flush=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"SM clock now, max: {clocks}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where K2's time goes: the cycles of each step of `csrc/wavefront.cu`.

    python3 tools/torch_wavefront_trace.py

Copies this checkout's `kubernetes_autoscaler_tpu_torch/csrc/wavefront.cu`
(and the headers beside it) into a temporary directory, inserts a clock64()
read by thread 0 of the cluster's rank-0 CTA at fixed points of the kernel,
builds it with the port's nvcc flags and runs it, as the wrapper would
launch it, on the pool-partitioned world's filter pack (chip_smoke.py's
inputs), each launch checked byte-equal to the plain version. Inputs: as
given, with every mask bit clear (no live slot) and with the free plane
zero (every slot scanned, nothing placed). Prints, per input, the device
time (chip_smoke.cuda_ms) and the cycles of the prologue, of each live
wave's five steps and two barriers, and of the epilogue; then the SM clock
and the card line. A mark after a barrier includes the wait at it. The
points are found by the kernel's own comments; the tool fails if one is
missing. Needs a card.
"""

from __future__ import annotations

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

MAX_WAVES = 34
WAVE_BASE = 10
STEPS = ("1 fits and chunk sums", "2 chunk offsets, CTA totals", "cluster barrier",
         "3 lower CTAs' totals", "4 places and delta", "5 plane update")
# (anchor line, where to put the mark: "before" or "after", mark)
PROLOGUE = (
    ("  // ---- prologue: what the cluster knows before the first wave.", "before", "0"),
    ("  cluster.sync();  // every CTA's any_s has arrived", "before", "1"),
    ("  cluster.sync();  // every CTA's any_s has arrived", "after", "2"),
    ("  // ---- the waves: every slot of a wave against the wave-start capacity",
     "before", "3"),
    ("  // ---- epilogue", "before", "4"),
    ("  // no CTA may leave while another can still store into its shared memory",
     "before", "5"),
)
WAVE = (
    ("    const int ntask = nl * mchunk;", "after", 0),
    ("    // 2. each slot", "before", 1),
    ("    cluster.sync();  // every CTA's totals of the wave are in", "before", 2),
    ("    cluster.sync();  // every CTA's totals of the wave are in", "after", 3),
    ("    // 4. each task", "before", 4),
    ("    // 5. this CTA's lanes", "before", 5),
    ("    buf ^= 1u;", "before", 6),
)
HEADER = """
__device__ unsigned long long ka_trace[256];
#define KA_MARK(i) do { if (threadIdx.x == 0 && cg::this_cluster().block_rank() == 0 \\
    && (i) < 256) ka_trace[(i)] = clock64(); } while (0)
"""
FOOTER = """
extern "C" int ka_trace_reset() {
  static unsigned long long zero[256];
  return static_cast<int>(cudaMemcpyToSymbol(ka_trace, zero, sizeof(zero)));
}
extern "C" int ka_trace_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, ka_trace, sizeof(ka_trace)));
}
"""


def instrument(src: str) -> str:
    """The kernel source with the marks inserted."""
    lines = src.split("\n")

    def put(anchor, where, stmt):
        hits = [i for i, line in enumerate(lines) if line.startswith(anchor)]
        if len(hits) != 1:
            raise SystemExit(f"anchor not found once in wavefront.cu: {anchor!r}")
        i = hits[0] + (1 if where == "after" else 0)
        lines.insert(i, stmt)

    for anchor, where, mark in PROLOGUE:
        put(anchor, where, f"  KA_MARK({mark});")
    for anchor, where, step in WAVE:
        put(anchor, where, f"    KA_MARK({WAVE_BASE} + 7 * min(wave_no, {MAX_WAVES - 1}) + {step});")
    put("  unsigned buf = 0;", "after", "  int wave_no = 0;")
    put("    buf ^= 1u;", "after", "    ++wave_no;")
    out = "\n".join(lines)
    out = out.replace('namespace cg = cooperative_groups;',
                      'namespace cg = cooperative_groups;\n' + HEADER, 1)
    # the last mark: after the kernel's final (conditional) cluster barrier
    tail = "  if (!synced) cluster.sync();\n}\n\nusing KernelFn"
    if tail not in out:
        raise SystemExit("the kernel's final cluster barrier was not found")
    out = out.replace(tail, "  if (!synced) cluster.sync();\n  KA_MARK(6);\n}\n\nusing KernelFn", 1)
    return out + FOOTER


def build(tmp: str) -> ctypes.CDLL:
    from kubernetes_autoscaler_tpu_torch.ops.kernels import build as kbuild

    for header in kbuild.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, tmp)
    src = os.path.join(tmp, "wavefront_trace.cu")
    with open(src, "w") as f:
        f.write(instrument((kbuild.CSRC_DIR / "wavefront.cu").read_text()))
    lib = os.path.join(tmp, "libwavefront_trace.so")
    r = subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", lib, src],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(lib)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_wavefront_trace: no CUDA device", file=sys.stderr)
        return 1
    from kubernetes_autoscaler_tpu_torch.ops.bitplane import pack_group_bits
    from kubernetes_autoscaler_tpu_torch.ops.kernels import wavefront_kernel
    from kubernetes_autoscaler_tpu_torch.ops.pack import WavefrontCache
    from kubernetes_autoscaler_tpu_torch.ops.schedule import (
        filter_pack_inputs,
        plan_wavefronts,
    )

    card = cs.card_line()
    enc, _ = cs.build_world(cs.NODES, cs.PODS, cs.POD_GROUPS, cs.NODEGROUPS, 0,
                            cs.DEVICE, pools=cs.POOLS, bench_load=True)
    plan = plan_wavefronts(enc.nodes, enc.specs, WavefrontCache())
    free, mask, req, count, _, limit_one = filter_pack_inputs(
        enc.nodes, enc.specs, enc.scheduled)
    bits = (free, pack_group_bits(mask), req, count, limit_one.to(torch.int32),
            plan.waves)
    inputs = {"as given": bits,
              "every mask bit clear": (free, torch.zeros_like(bits[1]), *bits[2:]),
              "free plane zero": (torch.zeros_like(free), *bits[1:])}
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        fn = lib.ka_pack_groups_wavefront
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def launch(b):
            n, r = b[0].shape
            g = b[2].shape[0]
            w, s = b[5].shape
            placed = torch.empty((g, n), dtype=torch.int32, device=b[0].device)
            free_after = torch.empty_like(b[0])
            sched = torch.empty((g,), dtype=torch.int32, device=b[0].device)
            rc = fn(*[t.data_ptr() for t in (*b, placed, free_after, sched)],
                    g, n, r, w, s, 0, 0, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return placed, free_after, sched

        for name, b in inputs.items():
            mask_b = (torch.zeros_like(mask) if name == "every mask bit clear"
                      else mask)
            want = wavefront_kernel.pack_groups_wavefront_plain(
                b[0], mask_b, req, count, limit_one, plan.waves)
            got = launch(b)
            torch.cuda.synchronize()
            for a, ref in zip(got, (want.placed, want.free_after, want.scheduled)):
                if not torch.equal(a, ref):
                    raise AssertionError(f"{name}: differs from the plain version")
            ms = cs.cuda_ms(lambda b=b: launch(b), cs.REPS, hold=True)
            lib.ka_trace_reset()
            launch(b)
            torch.cuda.synchronize()
            tr = (ctypes.c_ulonglong * 256)()
            lib.ka_trace_read(tr)
            pro = [tr[i + 1] - tr[i] for i in range(3)]
            waves = []
            for k in range(MAX_WAVES):
                m = [tr[WAVE_BASE + 7 * k + i] for i in range(7)]
                if m[0] == 0:
                    break
                waves.append(dict(zip(STEPS, (m[i + 1] - m[i] for i in range(6)))))
            print(json.dumps({
                "inputs": name, "device_ms": ms,
                "prologue_cycles": {"loads, stores, any_s pushed": pro[0],
                                    "cluster barrier": pro[1],
                                    "liveness, fit lists, wave lists": pro[2]},
                "waves_cycles": waves,
                "epilogue_cycles": {"zero rows, plane out": tr[5] - tr[4],
                                    "final cluster barrier (no live wave only)":
                                        tr[6] - tr[5]},
                "kernel_cycles": tr[6] - tr[0]}), flush=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"SM clock now, max: {clocks}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

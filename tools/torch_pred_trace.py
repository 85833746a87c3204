#!/usr/bin/env python3
"""Where row P's time goes: the cycles of each step of `csrc/predicates.cu`'s
plane kernel, and the device time of each kernel its C entry enqueues.

    python3 tools/torch_pred_trace.py [TREE]

TREE (default: this checkout) holds the plane kernel's source at
`kubernetes_autoscaler_tpu_torch/csrc/predicates.cu` in the design that
takes the resident pods. The source is copied into a temporary directory, a
clock64() read by lane 0 of each warp of block 0 is inserted at the
plane kernel's `// trace:` comments (the tool fails if they are not one
start, marks, one end), kept in shared memory and written out after a
last barrier; the copy is built with the port's nvcc flags. THIS
checkout's `chip_smoke.py` records every distinct plane call of one
`[main]` and one `[constrained]` step (tools/torch_kernel_ab.py's
`pred_inputs`), and each runs through the instrumented copy, checked
byte-equal to this checkout's plain version. Prints, per call and mark,
each warp's cycles from the kernel's start to its last pass there (a mark
in a loop keeps its last pass) and the hits, so a barrier shows as the
warps arriving apart and leaving together; then (this checkout's wrapper,
uninstrumented, under torch.profiler, 20 calls) the device time a call of
each kernel the C entry enqueues (the memset, the resident pre-pass, the
plane), then the SM clock and the card line. Needs a card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import torch_kernel_ab as ab  # noqa: E402

# the source's anchors: "// trace: start" (the clock's zero), "// trace:
# <what ran since the mark before>" and "// trace: end: <what ran since>"
ANCHOR = "// trace:"
END = "end:"
PRELUDE = r"""
__device__ long long ka_trace_out[2 * 32 * 16];
#define KA_START() __shared__ long long ka_stamp[32][16]; __shared__ long long ka_hits[32][16]; \
  if (blockIdx.x == 0 && (threadIdx.x & 31) == 0) \
    for (int i_ = 0; i_ < 16; ++i_) { ka_stamp[threadIdx.x >> 5][i_] = 0; ka_hits[threadIdx.x >> 5][i_] = 0; } \
  const long long ka_t0 = clock64();
#define KA_MARK(i) do { if (blockIdx.x == 0 && (threadIdx.x & 31) == 0) { \
    ka_stamp[threadIdx.x >> 5][i] = clock64() - ka_t0; ka_hits[threadIdx.x >> 5][i]++; } } while (0)
#define KA_END(i) do { KA_MARK(i); __syncthreads(); \
    for (int t_ = threadIdx.x; blockIdx.x == 0 && t_ < (int)blockDim.x / 32 * 16; t_ += blockDim.x) { \
      ka_trace_out[t_] = ka_stamp[t_ / 16][t_ % 16]; \
      ka_trace_out[32 * 16 + t_] = ka_hits[t_ / 16][t_ % 16]; } } while (0)
"""
EXPORT = r"""
extern "C" int ka_pred_trace(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, ka_trace_out, 2 * 32 * 16 * sizeof(long long)));
}
"""


def instrument(src: str) -> tuple[str, list]:
    """(the source with a clock read at each `// trace:` anchor, the marks'
    names in order), or a RuntimeError when the anchors are not one start,
    one end after it and 1 to 15 marks between them."""
    out, names = [], []
    started = ended = False
    for line in src.split("\n"):
        s = line.strip()
        if not s.startswith(ANCHOR):
            out.append(line)
            if s == "#include <atomic>":
                out.append(PRELUDE)
            continue
        what = s[len(ANCHOR):].strip()
        if what == "start" and not started:
            out.append("KA_START();")
            started = True
        elif what.startswith(END) and started and not ended:
            names.append(what[len(END):].strip())
            out.append(f"KA_END({len(names) - 1});")
            ended = True
        elif started and not ended and what:
            out.append(f"KA_MARK({len(names)});")
            names.append(what)
        else:
            raise RuntimeError(f"a trace anchor out of place: {s!r}")
    if not (started and ended and 2 <= len(names) <= 16):
        raise RuntimeError(f"trace anchors: start {started}, end {ended}, "
                           f"{len(names)} marks (2 to 16 with the end's)")
    return "\n".join(out) + EXPORT, names


def build(tree: str, out_dir: str) -> tuple[ctypes.CDLL, list]:
    from kubernetes_autoscaler_tpu_torch.ops.kernels import build as kb

    csrc = os.path.join(tree, "kubernetes_autoscaler_tpu_torch", "csrc")
    for name in os.listdir(csrc):
        if name.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, name), out_dir)
    with open(os.path.join(csrc, "predicates.cu")) as f:
        src, names = instrument(f.read())
    path = os.path.join(out_dir, "predicates_traced.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, "libpredtrace.so")
    proc = subprocess.run([kb.nvcc_path(), *kb.NVCC_FLAGS, "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(lib), names


def profile_kernels(args) -> dict:
    """{kernel name: device ms a call} of this checkout's wrapper on `args`
    (20 calls under torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from kubernetes_autoscaler_tpu_torch.ops.kernels import predicate_kernel as pk

    for _ in range(3):
        pk.plane(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            pk.plane(*args)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t and e.device_type.name == "CUDA":
            out[e.key] = t / 1e3 / 20
    return out


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    if not torch.cuda.is_available():
        print("torch_pred_trace: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    with tempfile.TemporaryDirectory() as tmp:
        lib, names = build(tree, tmp)
        trace = lib.ka_pred_trace
        trace.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        trace.restype = ctypes.c_int
        launch = ab.pred_launcher((lib, True))
        buf = (ctypes.c_longlong * (2 * 32 * 16))()
        for name, (_, args, want) in ab.pred_inputs().items():
            launch(*args)
            got = launch(*args)[0]
            torch.cuda.synchronize()
            trace(buf)
            if not torch.equal(got, want[0]):
                raise AssertionError(f"{name}: the instrumented kernel differs "
                                     f"from the plain version")
            print(f"[pred-trace] {name}: each warp's cycles from the start "
                  f"to its last pass at the mark (hits)", flush=True)
            for i, step in enumerate(names):
                warps = [(buf[w * 16 + i], buf[32 * 16 + w * 16 + i])
                         for w in range(32) if buf[32 * 16 + w * 16]]
                cells = " ".join(f"{c}({h})" if h else "-" for c, h in warps)
                print(f"[pred-trace]   {i:2d} {step}: {cells}", flush=True)
            for kernel, ms in sorted(profile_kernels(args).items()):
                print(f"[pred-trace]   device time a call (uninstrumented): "
                      f"{kernel}: {ms} ms", flush=True)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip()
    print(f"[pred-trace] SM clock, max: {clock}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

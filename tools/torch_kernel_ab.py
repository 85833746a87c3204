#!/usr/bin/env python3
"""K1 and K2 of each given tree, timed on the same inputs in one process.

    python3 tools/torch_kernel_ab.py TREE [TREE ...]

For each TREE (a checkout of the repo, e.g. the parent commit unpacked with
`git archive` into a directory .gitignore lists), its
`kubernetes_autoscaler_tpu_torch/csrc/pack.cu` and `wavefront.cu` are
compiled with this checkout's nvcc flags into a temporary directory and
loaded with ctypes. THIS checkout's `chip_smoke.py` builds the inputs once:
the pool-partitioned world's filter pack (K2, and K1 at B=1), and the main
world's filter (B=1) and option (B=24) packs (K1). Then, in rounds, every
tree's kernels run on those inputs in the order given (give them as parent,
change, change, parent), each launch first checked byte-equal to this
checkout's plain version, and each time is the device time (CUDA events with
the stream held while the host enqueues, median of chip_smoke.REPS).

A tree's K2 entry either takes a `delta` scratch plane (the one-CTA design)
or a cluster size and a free-plane placement and no scratch (the cluster
design, which also exports `ka_wavefront_config`); the tool calls whichever
the library has, letting the cluster design choose both. Prints one
JSON line per tree and round, then the card line; needs a card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

ROUNDS = 2


def build_tree(tree: str, out_dir: str) -> dict[str, ctypes.CDLL]:
    """The tree's two kernel libraries, compiled in parallel."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import build

    csrc = os.path.join(tree, "kubernetes_autoscaler_tpu_torch", "csrc")
    procs = {}
    for source in ("pack.cu", "wavefront.cu"):
        lib = os.path.join(out_dir, f"{source}.so")
        procs[source] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib,
             os.path.join(csrc, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for source, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tree}/{source}:\n{log}")
        libs[source] = ctypes.CDLL(lib)
    return libs


def k1_launcher(lib):
    fn = lib.ka_pack_groups_batched
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(free, bits, req, count, order, limit_one):
        b, n, r = free.shape
        g = req.shape[0]
        placed = torch.empty((b, g, n), dtype=torch.int32, device=free.device)
        free_after = torch.empty_like(free)
        sched = torch.empty((b, g), dtype=torch.int32, device=free.device)
        rc = fn(free.data_ptr(), bits.data_ptr(), req.data_ptr(),
                count.data_ptr(), order.data_ptr(), limit_one.data_ptr(),
                placed.data_ptr(), free_after.data_ptr(), sched.data_ptr(),
                b, g, n, r, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K1 launch failed: CUDA error {rc}")
        return placed, free_after, sched
    return launch


def k2_launcher(lib):
    fn = lib.ka_pack_groups_wavefront
    cluster = hasattr(lib, "ka_wavefront_config")
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 if cluster else
                   [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(free, bits, req, count, limit_one, waves):
        n, r = free.shape
        g = req.shape[0]
        w, s = waves.shape
        placed = torch.empty((g, n), dtype=torch.int32, device=free.device)
        free_after = torch.empty_like(free)
        sched = torch.empty((g,), dtype=torch.int32, device=free.device)
        ptrs = [t.data_ptr() for t in (free, bits, req, count, limit_one, waves,
                                       placed, free_after, sched)]
        stream = torch.cuda.current_stream().cuda_stream
        if cluster:
            rc = fn(*ptrs, g, n, r, w, s, 0, 0, stream)
        else:
            delta = torch.empty((r, n), dtype=torch.int32, device=free.device)
            rc = fn(*ptrs, delta.data_ptr(), g, n, r, w, s, stream)
        if rc != 0:
            raise RuntimeError(f"K2 launch failed: CUDA error {rc}")
        return placed, free_after, sched
    return launch


def inputs():
    """{name: (kernel, launch args with the mask bit-packed, plain result)}."""
    from kubernetes_autoscaler_tpu_torch.models.cluster_state import Dims
    from kubernetes_autoscaler_tpu_torch.ops import autoscale_step
    from kubernetes_autoscaler_tpu_torch.ops.binpack import option_pack_inputs
    from kubernetes_autoscaler_tpu_torch.ops.bitplane import pack_group_bits
    from kubernetes_autoscaler_tpu_torch.ops.kernels import (
        pack_kernel,
        wavefront_kernel,
    )
    from kubernetes_autoscaler_tpu_torch.ops.pack import WavefrontCache
    from kubernetes_autoscaler_tpu_torch.ops.schedule import (
        filter_pack_inputs,
        plan_wavefronts,
    )

    def k1_case(a):
        bits = (a[0], pack_group_bits(a[1]), *a[2:5], a[5].to(torch.int32))
        return "K1", bits, pack_kernel.pack_groups_batched_plain(*a)

    out = {}
    enc, groups = cs.build_world(cs.NODES, cs.PODS, cs.POD_GROUPS, cs.NODEGROUPS,
                                 0, cs.DEVICE, pools=cs.POOLS, bench_load=True)
    plan = plan_wavefronts(enc.nodes, enc.specs, WavefrontCache())
    free, mask, req, count, order, limit_one = filter_pack_inputs(
        enc.nodes, enc.specs, enc.scheduled)
    a = [free, mask, req, count, limit_one, plan.waves]
    out["K2 partitioned filter G=64 N=5120 waves [8,48]"] = (
        "K2", (free, pack_group_bits(mask), req, count,
               limit_one.to(torch.int32), plan.waves),
        wavefront_kernel.pack_groups_wavefront_plain(*a))
    out["K1 partitioned filter B=1"] = k1_case(
        [free[None].contiguous(), mask[None].contiguous(), req, count, order,
         limit_one])

    enc, groups = cs.build_world(cs.NODES, cs.PODS, cs.POD_GROUPS, cs.NODEGROUPS,
                                 cs.RESIDENTS_PER_NODE, cs.DEVICE)
    dims = Dims()
    limit_cap = torch.full((groups.ng,), cs.MAX_NEW_NODES, dtype=torch.int32,
                           device=cs.DEVICE)
    _, resident = autoscale_step.run_once_fused(
        enc.nodes, enc.specs, enc.scheduled, groups, limit_cap, dims,
        max_new_nodes=cs.MAX_NEW_NODES, max_pods_per_node=cs.MAX_PODS_PER_NODE)
    out["K1 main filter B=1"] = k1_case(
        [t[None].contiguous() if i < 2 else t for i, t in
         enumerate(filter_pack_inputs(enc.nodes, enc.specs, enc.scheduled))])
    capped = groups.replace(max_new=torch.minimum(groups.max_new, limit_cap))
    option_args, _ = option_pack_inputs(resident.specs, capped, dims,
                                        cs.MAX_NEW_NODES)
    out["K1 main options B=24"] = k1_case(list(option_args))
    return out


def main() -> int:
    trees = [os.path.abspath(t) for t in sys.argv[1:]]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    cases = inputs()
    with tempfile.TemporaryDirectory() as tmp:
        launchers = {}
        for i, tree in enumerate(dict.fromkeys(trees)):
            out_dir = os.path.join(tmp, str(i))
            os.makedirs(out_dir)
            libs = build_tree(tree, out_dir)
            launchers[tree] = {"K1": k1_launcher(libs["pack.cu"]),
                               "K2": k2_launcher(libs["wavefront.cu"])}
        for rnd in range(ROUNDS):
            for tree in trees:
                times = {}
                for name, (kernel, args, want) in cases.items():
                    fn = launchers[tree][kernel]
                    placed, free_after, sched = fn(*args)
                    torch.cuda.synchronize()
                    for got, ref in ((placed, want.placed),
                                     (free_after, want.free_after),
                                     (sched, want.scheduled)):
                        if not torch.equal(got, ref):
                            raise AssertionError(f"{tree} {name}: differs "
                                                 f"from the plain version")
                    times[name] = cs.cuda_ms(lambda fn=fn, args=args: fn(*args),
                                             cs.REPS, hold=True)
                print(json.dumps({"tree": tree, "round": rnd,
                                  "device_ms": times}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The port's kernels of each given tree, timed on the same inputs in one
process.

    python3 tools/torch_kernel_ab.py [--rows K1,K2,C,D,S,P] TREE [TREE ...]

For each TREE (a checkout of the repo, e.g. the parent commit unpacked with
`git archive` into a directory .gitignore lists), the sources of the rows
asked for (`kubernetes_autoscaler_tpu_torch/csrc/pack.cu` for K1,
`wavefront.cu` for K2, `constrained.cu` for row C, `drain.cu` for row D,
`histogram.cu` for row S, `predicates.cu` for row P) are compiled with
this checkout's nvcc flags
into a temporary directory,
all at once, and loaded with ctypes. THIS checkout's `chip_smoke.py` builds
the inputs once: the pool-partitioned world's filter pack (K2, and K1 at
B=1) and the main world's filter (B=1) and option (B=24) packs (K1); the
constrained world's filter (B=1) and option (B=24) packs (row C); the main
world's drain sweep, its reason pass, and the constrained world's sweep in
topology mode (row D); `hist_cases`' history feed at the recommender's
shape (20,000 aggregates x 192 samples into 33,790 rows), its RunOnce feed
and its skewed batch (row S); every distinct plane call (checks, kind, G,
N) of one `[main]` step and one `[constrained]` step (row P). Then, in
rounds, every tree's kernels run on
those inputs in the order given (give them as parent, change, change,
parent), each launch first checked byte-equal to this checkout's plain
version (computed once, on the card; row S's on the CPU, where its order
holds), and each time is the device time (CUDA events with the stream held
while the host enqueues, median of chip_smoke.REPS). Row S also reports
its time as launched from Python (`launched_ms`): the whole operation,
which for a tree whose entry takes the samples sorted by row (the first
design) includes the index wrap and the stable `torch.sort` before it.
Row P reports it too: a tree without `predicates.cu` (an older port) built
its planes with the plain version, so for it row P is THIS checkout's plain
version on the card (the same code, moved), whose time as launched is
mostly the host's enqueue of its ≈ 570 launches. The filter's and the
drain's planes carry the resident self-anti-affinity term: a tree whose
entry takes the resident pods (its source names `kResValid`) computes it in
the same call; for one whose entry does not (the first design), the time is
its plane's plus THIS checkout's plain term after it
(`resident_group_counts` and the elementwise AND, as that tree's callers
ran it).

A tree's K2 entry either takes a `delta` scratch plane (the one-CTA design)
or a cluster size and a free-plane placement and no scratch (the cluster
design, which also exports `ka_wavefront_config`). A tree's row C entry
either takes a mode, a zone order by zone alone and a [B, N] scratch (the
one-CTA design) or a cluster size, a placement and a [B, 4, N] scratch,
sorting by zone itself (the cluster design, which exports
`ka_constrained_config`). Row D's entry takes a pointer array: the fit
plane's scratch rides at its end, which a tree without the pre-pass never
reads. Row S's entry either takes (sorted rows, order) from a library sort
(the first design) or the raw samples and a workspace, ordering them itself
(the radix design, which exports `ka_hist_workspace`). The tool calls
whichever each library has. Prints one JSON line per tree and round, then
the card line; needs a card.
"""

from __future__ import annotations

import argparse
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
SOURCES = {"K1": "pack.cu", "K2": "wavefront.cu", "C": "constrained.cu",
           "D": "drain.cu", "S": "histogram.cu", "P": "predicates.cu"}

# csrc/constrained.cu's Field enum of the one-CTA design (with the kPlace
# mode's `active` row), in order
CON_FIELDS_ONE_CTA = (
    "free_in", "free_out", "placed", "feas", "req", "want", "limit", "active",
    "order", "s_kind", "s_skew", "s_self", "s_cnt_node", "s_elig", "a_kind",
    "a_self", "a_any", "a_ok_node", "anti_self_zone", "cnt_zone_base",
    "elig_zone_base", "min_host_base", "zone_cl", "zone_valid", "perm", "skey",
    "scratch", "waves")


def build_tree(tree: str, out_dir: str, rows, sources=None) -> dict:
    """{row: library} of the tree's kernels, compiled in parallel.
    `sources` maps a row to a source path to build instead (an instrumented
    copy). A tree without row P's source gets None for it (its plane was
    the plain version)."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import build

    csrc = os.path.join(tree, "kubernetes_autoscaler_tpu_torch", "csrc")
    procs = {}
    libs = {}
    for row in rows:
        src = (sources or {}).get(row) or os.path.join(csrc, SOURCES[row])
        if row == "P" and not os.path.exists(src):
            libs[row] = None
            continue
        if row == "P":
            with open(src) as f:
                libs["P residents"] = "kResValid" in f.read()
        lib = os.path.join(out_dir, f"{row}.so")
        procs[row] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for row, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tree} row {row}:\n{log}")
        libs[row] = ctypes.CDLL(lib)
    if libs.get("P") is not None:
        libs["P"] = (libs["P"], libs.pop("P residents"))
    libs.pop("P residents", None)
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


def con_launcher(lib, counter=None, cluster=0):
    """Row C's pack (a recorded pack_lanes call's arguments) through `lib`,
    either design; the lanes' waves are added to `counter` (i64[1]). A
    cluster design's `cluster` forces its cluster size (0: its choice)."""
    from kubernetes_autoscaler_tpu_torch.ops.constrained import MAX_WAVES
    from kubernetes_autoscaler_tpu_torch.ops.kernels import (
        constrained_kernel as ck,
    )

    design = "cluster" if hasattr(lib, "ka_constrained_config") else "one_cta"
    fn = lib.ka_constrained
    if design == "cluster":
        fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p),
                        ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.ka_constrained_config.argtypes = ([ctypes.c_int] * 6
                                              + [ctypes.POINTER(ctypes.c_int)])
        lib.ka_constrained_config.restype = ctypes.c_int
    else:
        fn.argtypes = ([ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                        ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.ka_constrained_plane.argtypes = [ctypes.c_int] * 3
        lib.ka_constrained_plane.restype = ctypes.c_int
    fn.restype = ctypes.c_int

    def launch(free, mask, req, count, order, limit_one, cons, z):
        b, n, r = free.shape
        g = req.shape[0]
        dev = free.device
        ls = {"free_in": ck._lane("free", free, torch.int32, b, (n, r), dev),
              "feas": ck._lane("mask", mask, torch.bool, b, (g, n), dev),
              **ck._cons_strides(cons, b, g, n, z, dev)}
        free_after = torch.empty((b, n, r), dtype=torch.int32, device=dev)
        placed = torch.zeros((b, g, n), dtype=torch.int32, device=dev)
        t = {"free_in": free, "free_out": free_after, "placed": placed,
             "feas": mask, "req": req, "want": count, "limit": limit_one,
             "order": order, **vars(cons),
             "waves": counter if counter is not None else torch.zeros(
                 (1,), dtype=torch.int64, device=dev)}
        stream = torch.cuda.current_stream().cuda_stream
        if design == "cluster":   # each CTA sorts its nodes by zone itself
            cfg = (ctypes.c_int * 5)()
            rc = lib.ka_constrained_config(b, n, r, z, cluster, 0, cfg)
            if rc != 0:
                raise RuntimeError(f"row C config failed: CUDA error {rc}")
            smem = bool(cfg[3])
            t["scratch"] = None if smem else torch.empty(
                (b, 4, n), dtype=torch.int32, device=dev)
            fields = ck.FIELDS
        else:   # the one-CTA design takes the zone order from the caller
            shared = ls["zone_cl"] == 0 and ls["zone_valid"] == 0
            zcl, zval = t["zone_cl"], t["zone_valid"]
            if shared:
                zcl, zval = zcl[:1], zval[:1]
            smem = lib.ka_constrained_plane(n, r, z) == 1
            key = torch.where(zval, zcl.clamp(0, z - 1), z)
            perm = torch.argsort(key, dim=1, stable=True)
            t["perm"], t["skey"] = perm.to(torch.int32), \
                key.gather(1, perm).to(torch.int32)
            t["scratch"] = None if smem else torch.empty(
                (b, n), dtype=torch.int32, device=dev)
            ls["perm"] = ls["skey"] = 0 if shared else n
            fields = CON_FIELDS_ONE_CTA
        ptrs = (ctypes.c_void_p * len(fields))(*[
            t[f].data_ptr() if t.get(f) is not None else None for f in fields])
        lane = (ctypes.c_longlong * len(fields))(*[ls.get(f, 0)
                                                   for f in fields])
        if design == "cluster":
            rc = fn(ptrs, lane, b, g, n, r, z, MAX_WAVES, cfg[0],
                    2 if smem else 1, stream)
        else:
            rc = fn(1, ptrs, lane, b, g, n, r, z, MAX_WAVES, int(smem), stream)
        if rc != 0:
            raise RuntimeError(f"row C launch failed: CUDA error {rc}")
        return free_after, placed, placed.sum(dim=-1, dtype=torch.int32)
    return launch


def drain_launcher(lib):
    """Row D's sweep (SweepInputs, K, explain, TopoInputs or None) through
    `lib`; the fit plane's scratch is the pointer array's last entry."""
    from kubernetes_autoscaler_tpu_torch.ops.constrained import MAX_WAVES
    from kubernetes_autoscaler_tpu_torch.ops.kernels import drain_kernel as dk

    fn = lib.ka_drain
    fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    counters = {}

    def launch(inp, kk, explain, topo):
        n, r = inp.free.shape
        g = inp.req.shape[0]
        c = inp.candidates.shape[0]
        dev = inp.free.device

        def empty(*shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device=dev)

        t = dict(vars(inp))
        if explain:
            outs = (empty(c), empty(c), empty(c))
            t["out0"], t["out1"], t["out2"] = outs
        else:
            outs = (empty(c, dtype=torch.bool), empty(c, dtype=torch.bool),
                    empty(c), empty(c), empty(c, inp.mpn), empty(c, inp.mpn))
            (t["out0"], t["out1"], t["out2"], t["out3"], t["dest_node"],
             t["pod_slot"]) = outs
        if "nodes" not in counters:
            counters["nodes"] = torch.zeros((1,), dtype=torch.int64, device=dev)
            counters["waves"] = torch.zeros((2,), dtype=torch.int64, device=dev)
        t["nodes"] = counters["nodes"]
        z = 0
        if topo is not None:
            t.update(vars(topo))
            t["perm"], t["skey"] = dk.zone_order(topo)
            t["waves"] = counters["waves"]
            z = topo.max_zones
        t["fit0"] = empty(g, (n + 7) // 8 * 8, dtype=torch.int16)
        ptrs = (ctypes.c_void_p * len(dk.FIELDS))(*[
            t[f].data_ptr() if t.get(f) is not None else None
            for f in dk.FIELDS])
        rc = fn(ptrs, c, n, r, g, inp.node_idx.shape[0], inp.mpn, kk, z,
                MAX_WAVES, int(explain), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"row D launch failed: CUDA error {rc}")
        return outs
    return launch


def hist_launcher(lib):
    """Row S's scatter (weights, total, agg, bucket, w; the bank updated in
    place) through `lib`, either design."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels.histogram_kernel import (
        _wrap,
    )

    fn = lib.ka_hist_scatter
    radix = hasattr(lib, "ka_hist_workspace")
    if radix:
        fn.argtypes = ([ctypes.c_void_p] * 6
                       + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.ka_hist_workspace.argtypes = [ctypes.c_int64, ctypes.c_int]
        lib.ka_hist_workspace.restype = ctypes.c_int64
    else:
        fn.argtypes = ([ctypes.c_void_p] * 6
                       + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def launch(weights, total, agg, bucket, w):
        a, b = weights.shape
        n = agg.shape[0]
        stream = torch.cuda.current_stream().cuda_stream
        if radix:
            words = lib.ka_hist_workspace(n, a)
            ws = torch.empty((words,), dtype=torch.int32, device=agg.device)
            rc = fn(agg.data_ptr(), bucket.data_ptr(), w.data_ptr(),
                    weights.data_ptr(), total.data_ptr(), ws.data_ptr(),
                    words, n, a, b, 0, stream)
        else:
            rows, order = torch.sort(_wrap(agg, a), stable=True)
            rc = fn(rows.data_ptr(), order.data_ptr(), bucket.data_ptr(),
                    w.data_ptr(), weights.data_ptr(), total.data_ptr(), n, a,
                    b, stream)
        if rc != 0:
            raise RuntimeError(f"row S launch failed: CUDA error {rc}")
        return weights, total
    return launch


def pred_launcher(lib):
    """Row P's plane (nodes, specs, checks, bits, group_mask, scheduled)
    through `lib` ((library, whether its entry takes the resident pods));
    with no library (a tree before row P), this checkout's plain version on
    the card. An entry without the resident pods gets this checkout's plain
    resident term after its plane."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import predicate_kernel as pk

    if lib is None:
        return lambda *args: (pk.plane_plain(*args),)
    lib, takes_residents = lib
    fn = lib.ka_pred_plane
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # the first design's Field enum ends with the group mask and the
    # output, its Dim enum with PP
    first = len(pk.FIELDS) + 2, len(pk.DIMS) - 1

    def launch(nodes, specs, checks, bits, group_mask, scheduled=None):
        d, dev, ts = pk._contract(nodes, specs, checks, bits, group_mask,
                                  scheduled)
        out = torch.empty((d["G"], d["N"]),
                          dtype=torch.uint16 if bits else torch.bool,
                          device=dev)
        ts[pk.OUT] = out
        if takes_residents:
            if scheduled is not None:
                ts[pk.WORDS] = torch.empty(((d["G"] + 31) // 32) * d["N"],
                                           dtype=torch.int32, device=dev)
            nf, nd = len(ts), len(pk.DIMS)
        else:
            nf, nd = first
        ptrs = [None if t is None else t.data_ptr() for t in ts[:nf]]
        dims = [d[k] for k in pk.DIMS[:nd]]
        rc = fn((ctypes.c_void_p * nf)(*ptrs), (ctypes.c_int * nd)(*dims),
                checks, int(bits), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"row P launch failed: CUDA error {rc}")
        if scheduled is not None and not takes_residents:
            resident = pk.resident_group_counts(scheduled, d["G"], d["N"])
            out = out & ~(specs.anti_affinity_self[:, None] & (resident > 0))
        return (out,)
    return launch


def pred_inputs() -> dict:
    """{name: ("P", plane args, (plain plane,))} of every distinct plane
    call of one [main] step and one [constrained] step (with and without
    the resident pods)."""
    from kubernetes_autoscaler_tpu_torch.models.cluster_state import Dims
    from kubernetes_autoscaler_tpu_torch.ops.kernels import predicate_kernel as pk

    out, seen = {}, set()
    dims = Dims()
    enc, groups = cs.build_world(cs.NODES, cs.PODS, cs.POD_GROUPS,
                                 cs.NODEGROUPS, cs.RESIDENTS_PER_NODE,
                                 cs.DEVICE)
    worlds = (("[main]", cs.main_step(enc, groups, dims)[1]),
              ("[constrained]", cs.constrained_world(dims)[2]))
    for tag, step in worlds:
        step()
        for i, args in enumerate(cs.record_pred_calls(step)):
            d, _ = pk.check_inputs(*args)
            key = (args[2], args[3], d["G"], d["N"], args[5] is not None)
            if key in seen:
                continue
            seen.add(key)
            kind = {pk.STATIC: "static", pk.SELECTOR: "selector"}.get(
                args[2], f"checks {args[2]}")
            if args[5] is not None:
                kind += f"+residents P={d['P']}"
            out[f"P {tag} call {i} {kind} G={d['G']} N={d['N']}"] = (
                "P", args, (pk.plane_plain(*args),))
    return out


def con_inputs():
    """Row C's and row D's topology inputs from one step of the constrained
    world: ({name: pack_lanes args}, (SweepInputs, TopoInputs, K))."""
    from kubernetes_autoscaler_tpu_torch.models.cluster_state import Dims

    _, _, step = cs.constrained_world(Dims())
    step()
    torch.cuda.synchronize()
    return cs.record_con_calls(step)


def inputs(rows):
    """{name: (row, launch args, plain result)}."""
    from kubernetes_autoscaler_tpu_torch.models.cluster_state import Dims
    from kubernetes_autoscaler_tpu_torch.ops import autoscale_step
    from kubernetes_autoscaler_tpu_torch.ops.binpack import option_pack_inputs
    from kubernetes_autoscaler_tpu_torch.ops.bitplane import pack_group_bits
    from kubernetes_autoscaler_tpu_torch.ops.kernels import (
        constrained_kernel,
        drain_kernel,
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
    if "P" in rows:
        out.update(pred_inputs())
    if "S" in rows:
        from kubernetes_autoscaler_tpu_torch.ops.kernels import (
            hist_cases,
            histogram_kernel,
        )

        for name, args in (
                ("S history A=33790 n=3840000",
                 hist_cases.history_case(20_000, 192, 33_790)),
                ("S RunOnce A=33790 n=100000", hist_cases.CASES["run_once"]()),
                ("S skewed A=500 n=60000", hist_cases.CASES["skewed"]())):
            want = [a.clone() for a in args[:2]]
            histogram_kernel.scatter_add_ordered_plain(*want, *args[2:])
            out[name] = ("S", tuple(a.to(cs.DEVICE) for a in args),
                         tuple(want))
    if "K1" in rows or "K2" in rows:
        enc, groups = cs.build_world(cs.NODES, cs.PODS, cs.POD_GROUPS,
                                     cs.NODEGROUPS, 0, cs.DEVICE, pools=cs.POOLS,
                                     bench_load=True)
        plan = plan_wavefronts(enc.nodes, enc.specs, WavefrontCache())
        free, mask, req, count, order, limit_one = filter_pack_inputs(
            enc.nodes, enc.specs, enc.scheduled)
        a = [free, mask, req, count, limit_one, plan.waves]
        if "K2" in rows:
            out["K2 partitioned filter G=64 N=5120 waves [8,48]"] = (
                "K2", (free, pack_group_bits(mask), req, count,
                       limit_one.to(torch.int32), plan.waves),
                wavefront_kernel.pack_groups_wavefront_plain(*a))
        if "K1" in rows:
            out["K1 partitioned filter B=1"] = k1_case(
                [free[None].contiguous(), mask[None].contiguous(), req, count,
                 order, limit_one])

    if "K1" in rows or "D" in rows:
        enc, groups = cs.build_world(cs.NODES, cs.PODS, cs.POD_GROUPS,
                                     cs.NODEGROUPS, cs.RESIDENTS_PER_NODE,
                                     cs.DEVICE)
        dims = Dims()
        if "K1" in rows:
            limit_cap = torch.full((groups.ng,), cs.MAX_NEW_NODES,
                                   dtype=torch.int32, device=cs.DEVICE)
            _, resident = autoscale_step.run_once_fused(
                enc.nodes, enc.specs, enc.scheduled, groups, limit_cap, dims,
                max_new_nodes=cs.MAX_NEW_NODES,
                max_pods_per_node=cs.MAX_PODS_PER_NODE)
            out["K1 main filter B=1"] = k1_case(
                [t[None].contiguous() if i < 2 else t for i, t in
                 enumerate(filter_pack_inputs(enc.nodes, enc.specs,
                                              enc.scheduled))])
            capped = groups.replace(max_new=torch.minimum(groups.max_new,
                                                          limit_cap))
            option_args, _ = option_pack_inputs(resident.specs, capped, dims,
                                                cs.MAX_NEW_NODES)
            out["K1 main options B=24"] = k1_case(list(option_args))
        if "D" in rows:
            _, step = cs.main_step(enc, groups, dims)
            inp, kk = cs.record_drain_call(step)
            for explain, name in ((False, "D [main] sweep"),
                                  (True, "D [main] reason pass")):
                out[name] = ("D", (inp, kk, explain, None),
                             drain_kernel.sweep_plain(inp, kk, explain))

    if "C" in rows or "D" in rows:
        calls, (dinp, dtopo, dkk) = con_inputs()
        if "C" in rows:
            for name, args in calls.items():
                res = constrained_kernel.pack_lanes_plain(*args)
                out[f"C [constrained] {name} B={args[0].shape[0]}"] = (
                    "C", args, (res.free_after, res.placed, res.scheduled))
        if "D" in rows:
            out["D [constrained] sweep, topology mode"] = (
                "D", (dinp, dkk, False, dtopo),
                drain_kernel.sweep_plain(dinp, dkk, False, topo=dtopo))
    return out


def flat(row, res):
    if row in ("K1", "K2"):
        return (res.placed, res.free_after, res.scheduled)
    return tuple(res)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default="K1,K2,C,D,S,P",
                    help="comma-separated rows to build and time")
    ap.add_argument("trees", nargs="+")
    a = ap.parse_args()
    rows = [r for r in a.rows.split(",") if r]
    if set(rows) - set(SOURCES):
        print(f"unknown rows {set(rows) - set(SOURCES)}", file=sys.stderr)
        return 2
    trees = [os.path.abspath(t) for t in a.trees]
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    with tempfile.TemporaryDirectory() as tmp:
        launchers = {}
        for i, tree in enumerate(dict.fromkeys(trees)):
            out_dir = os.path.join(tmp, str(i))
            os.makedirs(out_dir)
            libs = build_tree(tree, out_dir, rows)
            make = {"K1": k1_launcher, "K2": k2_launcher, "C": con_launcher,
                    "D": drain_launcher, "S": hist_launcher,
                    "P": pred_launcher}
            launchers[tree] = {row: make[row](lib) for row, lib in libs.items()}
        cases = inputs(rows)
        torch.cuda.synchronize()
        print(json.dumps({"cases": list(cases)}), flush=True)
        for rnd in range(ROUNDS):
            for tree in trees:
                times, launched = {}, {}
                for name, (row, args, want) in cases.items():
                    fn = launchers[tree][row]
                    if row == "S":   # in place: a fresh bank each run
                        got = fn(*[a.clone() for a in args[:2]], *args[2:])
                        args = (*[a.clone() for a in args[:2]], *args[2:])
                    else:
                        got = fn(*args)
                    torch.cuda.synchronize()
                    for k, (g, w) in enumerate(zip(got, flat(row, want))):
                        g, w = g.cpu(), w.cpu()
                        if g.dtype != w.dtype or g.shape != w.shape or \
                                g.numpy().tobytes() != w.numpy().tobytes():
                            raise AssertionError(f"{tree} {name}: output {k} "
                                                 f"differs from the plain "
                                                 f"version")
                    times[name] = cs.cuda_ms(lambda fn=fn, args=args: fn(*args),
                                             cs.REPS, hold=True)
                    if row in ("S", "P"):
                        launched[name] = cs.cuda_ms(
                            lambda fn=fn, args=args: fn(*args), cs.REPS)
                line = {"tree": tree, "round": rnd, "device_ms": times}
                if launched:
                    line["launched_ms"] = launched
                print(json.dumps(line), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--profile DIR]

Phases, in order; any failure exits non-zero and no phase carries on past
its own failure:

  1. device   the card's name and power limit (nvidia-smi); no CUDA → exit 1
  2. build    every CUDA source of the port, built with nvcc (timed)
  3. kernels  each kernel against its plain PyTorch version on the card,
              byte for byte, on seeded cases and on the inputs the main path
              gives it; kernel and plain times at the main-path shapes
  4. main     `run_once_fused` on the bench world (5,000 nodes, 50,000
              pending pods in 25 groups, 40,000 residents, 20 node groups),
              step and phase times, launches per step, peak memory,
              invariants, and with --profile device time by kernel and the
              device's busy share; then a 512-node world run on the CPU and
              on the card, every integer and bool leaf byte-equal
  5. result   the kernels line, the card line, and the last line
              {"ok": true, "device": {...}}

Imports nothing of JAX and nothing of the JAX package: the world is built
and encoded by the port's own object model and encoder.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

DEVICE = "cuda"
H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM data sheet
H100_OPS_PER_S = 67e12        # float32 outside the tensor cores (no int32 entry)

# the world of the main path, at full size: bench.py's world and the
# scale-down bench's residents; the live loop's defaults (config/options.py)
NODES = 5000
PODS = 50000
POD_GROUPS = 25
NODEGROUPS = 20
RESIDENTS_PER_NODE = 8
MAX_NEW_NODES = 1024
MAX_PODS_PER_NODE = 128
SMALL_NODES = 512             # the CPU-vs-card comparison world
STEPS = 100                   # timed steps of the main path
REPS = 20                     # timed runs per kernel measurement


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median over `reps` runs of fn's time on the card (CUDA events,
    synchronized after each run), after `warmup` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


# ---------------------------------------------------------------- world


def build_world(n_nodes, n_pods, n_groups, n_nodegroups, residents_per_node,
                device, node_bucket=256, group_bucket=64):
    """The bench world (bench.py build_world: same labels, taints, zones,
    GPU nodes, 25 pending groups drawn from RandomState(0), 20 node-group
    templates) plus the scale-down bench's residents (800m / 256 MiB each,
    owners rs0..rs16) so the drain sweep does real work, then drainability.
    The residents carry the nodes' load instead of bench.py's synthetic 40%
    alloc (8 × 800m is 40% of a node's cpu)."""
    from kubernetes_autoscaler_tpu_torch.models.api import Taint, Toleration
    from kubernetes_autoscaler_tpu_torch.models.encode import (
        encode_cluster,
        encode_node_groups,
    )
    from kubernetes_autoscaler_tpu_torch.simulator.drainability.rules import (
        apply_drainability,
    )
    from kubernetes_autoscaler_tpu_torch.utils.testing import (
        build_test_node,
        build_test_pod,
    )

    rng = np.random.RandomState(0)
    zones = ["us-a", "us-b", "us-c"]
    nodes = []
    for i in range(n_nodes):
        taints = [Taint("dedicated", "infra", "NoSchedule")] if i % 10 == 0 else []
        nodes.append(build_test_node(
            f"node-{i}", cpu_milli=16000, mem_mib=65536, pods=110,
            labels={"pool": "a" if i % 2 else "b",
                    "disk": "ssd" if i % 3 else "hdd"},
            taints=taints, zone=zones[i % 3], gpus=8 if i % 25 == 0 else 0))
    per_group = n_pods // n_groups
    pods = []
    for g in range(n_groups):
        cpu = int(rng.choice([250, 500, 1000, 2000, 4000]))
        mem = int(rng.choice([256, 512, 2048, 8192]))
        sel = {"disk": "ssd"} if g % 4 == 0 else {}
        tol = [Toleration(key="dedicated", operator="Equal", value="infra",
                          effect="NoSchedule")] if g % 5 == 0 else []
        gpus = 1 if g % 7 == 0 else 0
        for i in range(per_group):
            pods.append(build_test_pod(
                f"pod-{g}-{i}", cpu_milli=cpu, mem_mib=mem, owner_name=f"rs-{g}",
                node_selector=sel, tolerations=tol, gpus=gpus))
    k = 0
    for nd in nodes:
        for _ in range(residents_per_node):
            pods.append(build_test_pod(
                f"res-{k}", cpu_milli=800, mem_mib=256,
                owner_name=f"rs{k % 17}", node_name=nd.name))
            k += 1
    enc = encode_cluster(nodes, pods, node_bucket=node_bucket,
                         group_bucket=group_bucket, device=device)
    apply_drainability(enc, now=0.0)
    templates = []
    for t in range(n_nodegroups):
        tmpl = build_test_node(
            f"template-{t}", cpu_milli=[4000, 8000, 16000, 32000][t % 4],
            mem_mib=[16384, 32768, 65536, 131072][t % 4], pods=110,
            labels={"pool": "a" if t % 2 else "b",
                    "disk": "ssd" if t % 3 else "hdd"},
            zone=zones[t % 3], gpus=8 if t % 5 == 0 else 0)
        templates.append((tmpl, 1000, float(1 + t)))
    groups = encode_node_groups(templates, enc.registry, enc.zone_table,
                                device=device)
    return enc, groups


def flat(tree, prefix=""):
    """{path: tensor} over a port result tree (None fields skipped)."""
    import dataclasses

    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}[{i}]"))
        return out
    out = {}
    for f in dataclasses.fields(tree):
        out.update(flat(getattr(tree, f.name), f"{prefix}.{f.name}"))
    return out


# ---------------------------------------------------------------- kernels


def pack_case(seed, b, g, n, r=8, max_count=3000, zero_req=True,
              limit_share=0.2, mask_p=0.8, device=None):
    """Seeded pack inputs on `device` (default DEVICE)."""
    from kubernetes_autoscaler_tpu_torch.ops.pack import ffd_order

    rng = np.random.default_rng(seed)
    free = torch.from_numpy(rng.integers(0, 40, size=(b, n, r)).astype(np.int32))
    req = torch.from_numpy(rng.integers(0, 6, size=(g, r)).astype(np.int32))
    if zero_req:
        req[0] = 0
    count = torch.from_numpy(rng.integers(0, max_count, size=(g,)).astype(np.int32))
    mask = torch.from_numpy(rng.random((b, g, n)) < mask_p)
    limit_one = torch.from_numpy(rng.random((g,)) < limit_share)
    order = ffd_order(req, torch.ones((g,), dtype=torch.bool))
    return [a.to(device or DEVICE)
            for a in (free, mask, req, count, order, limit_one)]


def pack_cases(device=None):
    device = device or DEVICE

    def case(*a, **kw):
        return pack_case(*a, device=device, **kw)

    cases = [(f"option shape B=20 G=64 N=1024, seed {s}", case(s, 20, 64, 1024))
             for s in range(3)]
    cases.append(("filter shape B=1 G=64 N=5120", case(3, 1, 64, 5120)))
    z = case(4, 2, 3, 200)
    z[0].zero_()
    z[2].zero_()
    z[3] = torch.tensor([7, 0, 2 ** 30], dtype=torch.int32, device=device)
    cases.append(("zero-request groups on empty nodes", z))
    cases.append(("limit_one groups", case(5, 4, 16, 700, limit_share=1.0)))
    b31 = case(6, 2, 32, 300)
    b31[1].zero_()
    b31[1][:, 31, :] = True
    cases.append(("only group 31 (the sign bit) feasible", b31))
    cases.append(("G=33 (two mask words)", case(7, 3, 33, 512)))
    cases.append(("N=1031, not a multiple of the block", case(8, 2, 12, 1031)))
    cases.append(("N=40, less than one warp per lane", case(9, 1, 5, 40)))
    cases.append(("N=8192: free plane in device memory", case(10, 2, 40, 8192)))
    return cases


def pack_bound(launch_args, mask):
    """(bound ms, 'bytes'|'operations') of one kernel launch on these
    inputs, as timed (`pack_kernel.launch`: the mask bit-packed, limit_one
    as int32): each input read once, each output written once; operations:
    4R integer ops (clamp, divide, min, update) per resource on every
    (row, group, lane) whose bit of the bool `mask` is set, plus 8 for the
    mask test, the caps and the scan on every (row, group, lane)."""
    free, req = launch_args[0], launch_args[2]
    b, n, r = free.shape
    g = req.shape[0]
    in_bytes = sum(t.numel() * t.element_size() for t in launch_args)
    out_bytes = (b * g * n + b * n * r + b * g) * 4   # placed, free_after, scheduled
    t_bytes = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
    ops = int(mask.sum()) * 4 * r + b * g * n * 8
    t_ops = ops / H100_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_pack(name, args, kernel, plain):
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = 0
    for field in ("placed", "scheduled", "free_after"):
        a, w = getattr(got, field), getattr(want, field)
        if a.dtype != w.dtype or a.shape != w.shape:
            raise AssertionError(f"{name}: {field} {a.dtype}{tuple(a.shape)} "
                                 f"vs {w.dtype}{tuple(w.shape)}")
        err = max(err, int((a.long() - w.long()).abs().max()) if a.numel() else 0)
        if not torch.equal(a, w):
            raise AssertionError(f"{name}: {field} differs from the plain version")
    log(f"[kernels] pack_groups_batched == plain: {name} "
        f"(B={args[0].shape[0]} G={args[2].shape[0]} N={args[0].shape[1]})")
    return err


def profile_step(step, step_ms_p50, out_dir):
    """One step under torch.profiler: device time by kernel name, the number
    of device kernels, and the device's busy share of an unprofiled step
    (summed kernel time over the step's p50). The trace goes to out_dir."""
    import os
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_name = defaultdict(lambda: [0, 0.0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name][0] += 1
            by_name[ev.name][1] += ev.time_range.elapsed_us() / 1e3
    if not by_name:
        raise AssertionError("the profiler saw no device kernel")
    kernels = sum(c for c, _ in by_name.values())
    busy_ms = sum(t for _, t in by_name.values())
    log(f"[profile] {kernels} device kernels in one step, {busy_ms} ms of "
        f"kernel time; busy share of the unprofiled step p50 "
        f"{busy_ms / step_ms_p50}")
    for name, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        log(f"[profile] {t} ms {c:6d}x {name[:110]}")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "chip_smoke_step.trace.json"))


# ---------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one step; the trace goes to DIR")
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the port itself: without the repo around this script, this fails here,
    # before anything is printed
    from kubernetes_autoscaler_tpu_torch.models.cluster_state import Dims
    from kubernetes_autoscaler_tpu_torch.ops import autoscale_step, drain
    from kubernetes_autoscaler_tpu_torch.ops.binpack import option_pack_inputs
    from kubernetes_autoscaler_tpu_torch.ops.bitplane import pack_group_bits
    from kubernetes_autoscaler_tpu_torch.ops.kernels import build, pack_kernel
    from kubernetes_autoscaler_tpu_torch.ops.schedule import filter_pack_inputs

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{kind} x{torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    libs = build.build([pack_kernel.SOURCE])
    log(f"[build] {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")

    kernel = pack_kernel.pack_groups_batched
    plain = pack_kernel.pack_groups_batched_plain

    # 3. kernels against their plain versions on seeded cases
    max_err = 0
    for name, case in pack_cases():
        max_err = max(max_err, check_pack(name, case, kernel, plain))

    # 4. the main path at full size
    dims = Dims()
    t0 = time.perf_counter()
    enc, groups = build_world(NODES, PODS, POD_GROUPS, NODEGROUPS,
                              RESIDENTS_PER_NODE, DEVICE)
    log(f"[main] world encoded in {time.perf_counter() - t0:.1f} s: "
        f"nodes {enc.nodes.n} (real {NODES}), pending groups "
        f"{int(enc.specs.valid.sum())}/{enc.specs.g} "
        f"({int(enc.specs.count.sum())} pods), residents "
        f"{int(enc.scheduled.valid.sum())}, node groups {groups.ng}, "
        f"max_new_nodes {MAX_NEW_NODES}, max_pods_per_node "
        f"{MAX_PODS_PER_NODE}, drain chunk "
        f"{drain.default_chunk(enc.nodes.n, enc.nodes.n, enc.nodes.cap.shape[1])}")
    limit_cap = torch.full((groups.ng,), MAX_NEW_NODES, dtype=torch.int32,
                           device=DEVICE)

    def step(on_phase=None):
        return autoscale_step.run_once_fused(
            enc.nodes, enc.specs, enc.scheduled, groups, limit_cap, dims,
            max_new_nodes=MAX_NEW_NODES, max_pods_per_node=MAX_PODS_PER_NODE,
            on_phase=on_phase)

    for _ in range(2):                                   # warm-up
        step()
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    pack_kernel.pack_groups_batched.launches = 0
    step_ms, phase_ms = [], {p: [] for p in autoscale_step.PHASES}
    for _ in range(STEPS):
        events = {}

        def on_phase(name, events=events):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name] = ev

        t0 = time.perf_counter()
        decision, resident = step(on_phase)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        bounds = list(autoscale_step.PHASES) + ["end"]
        for a, b in zip(bounds, bounds[1:]):
            phase_ms[a].append(events[a].elapsed_time(events[b]))
    launches = pack_kernel.pack_groups_batched.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"[main] step ms over {STEPS} steps: p50 {pct(step_ms, 50)} "
        f"p90 {pct(step_ms, 90)}")
    for p in autoscale_step.PHASES:
        log(f"[main] phase {p} ms (CUDA events): p50 {pct(phase_ms[p], 50)} "
            f"p90 {pct(phase_ms[p], 90)}")
    log(f"[main] pack kernel launches: {launches} in {STEPS} steps "
        f"({launches / STEPS:g} per step)")
    log(f"[main] peak device memory allocated: {peak_mib:.1f} MiB")
    if launches != 2 * STEPS:
        raise AssertionError(f"expected 2 pack launches per step, got {launches}")
    if args.profile:
        profile_step(step, pct(step_ms, 50), args.profile)

    # invariants of the last step
    d = decision
    valid_n = enc.nodes.valid
    if not bool((d.verdict <= enc.specs.count).all()):
        raise AssertionError("verdict exceeds the pending count")
    if not bool((d.alloc_after <= enc.nodes.cap)[valid_n].all()):
        raise AssertionError("alloc_after exceeds cap on a valid node")
    if not bool((d.est_scheduled <= d.pending_after[None, :]).all()):
        raise AssertionError("an option schedules more than is pending")
    for path, t in flat((decision, resident)).items():
        if t.dtype.is_floating_point and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{path} is not finite")
    best = int(torch.argmin(torch.where(d.scores.valid, d.scores.waste,
                                        float("inf"))))
    log(f"[main] verdict {int(d.verdict.sum())} placed on existing nodes, "
        f"pending after {int(d.pending_after.sum())}, options valid "
        f"{int(d.scores.valid.sum())}, least-waste option {best} "
        f"({int(d.est_node_count[best])} nodes), drainable "
        f"{int(d.drainable.sum())}, blocked {int(d.has_blocker.sum())}")

    # the kernel on the inputs the main path gives it, and its times there
    filter_args = [a[None].contiguous() if i < 2 else a for i, a in
                   enumerate(filter_pack_inputs(enc.nodes, enc.specs,
                                                enc.scheduled))]
    capped = groups.replace(max_new=torch.minimum(groups.max_new, limit_cap))
    option_args, _ = option_pack_inputs(resident.specs, capped, dims,
                                        MAX_NEW_NODES)
    shapes = {"filter": filter_args, "options": list(option_args)}
    ms = plain_ms = bound_ms = 0.0
    bound_by = "bytes"
    for name, a in shapes.items():
        max_err = max(max_err, check_pack(f"main-path {name} inputs", a,
                                          kernel, plain))
        bits = (a[0], pack_group_bits(a[1]), *a[2:5], a[5].to(torch.int32))
        k_ms = cuda_ms(lambda: pack_kernel.launch(*bits), REPS)
        # the same launch with every mask bit clear: no lane fits, so what is
        # left is the design's serial depth (G block scans and the writes)
        no_fit = (bits[0], torch.zeros_like(bits[1]), *bits[2:])
        depth_ms = cuda_ms(lambda: pack_kernel.launch(*no_fit), REPS)
        w_ms = cuda_ms(lambda: kernel(*a), REPS)
        p_ms = cuda_ms(lambda: plain(*a), REPS)
        b, n, r = a[0].shape
        bnd, by = pack_bound(bits, a[1])
        log(f"[kernels] pack_groups_batched {name} B={b} G={a[2].shape[0]} "
            f"N={n} R={r}: kernel {k_ms} ms, kernel with no lane fitting "
            f"(serial depth) {depth_ms} ms, wrapper with mask packing "
            f"{w_ms} ms, plain {p_ms} ms, "
            f"bound {bnd} ms ({by})")
        ms, plain_ms, bound_ms = ms + k_ms, plain_ms + p_ms, bound_ms + bnd
        if by == "operations":
            bound_by = by

    # the same step on the CPU and on the card at 512 nodes
    small = {}
    for dev in ("cpu", DEVICE):
        e, gr = build_world(SMALL_NODES, PODS * SMALL_NODES // NODES,
                            POD_GROUPS, NODEGROUPS, RESIDENTS_PER_NODE, dev)
        cap = torch.full((gr.ng,), MAX_NEW_NODES, dtype=torch.int32,
                         device=dev)
        small[dev] = flat(autoscale_step.run_once_fused(
            e.nodes, e.specs, e.scheduled, gr, cap, dims,
            max_new_nodes=MAX_NEW_NODES, max_pods_per_node=MAX_PODS_PER_NODE))
    worst_rel = 0.0
    for path, c in small["cpu"].items():
        g = small[DEVICE][path].cpu()
        if c.dtype != g.dtype or c.shape != g.shape:
            raise AssertionError(f"512-node {path}: dtype/shape differ")
        if c.dtype.is_floating_point:
            # the card sums in another order: rtol 1e-5 (f32, ≤1024 terms)
            rel = float(((g - c).abs() / c.abs().clamp(min=1e-30)).max()) \
                if c.numel() else 0.0
            worst_rel = max(worst_rel, rel)
            if not torch.allclose(g, c, rtol=1e-5, atol=0.0):
                raise AssertionError(f"512-node {path}: float leaf differs")
        elif not torch.equal(c, g):
            raise AssertionError(f"512-node {path}: CPU and card differ")
    log(f"[main] 512-node step: {len(small['cpu'])} leaves, every int and bool "
        f"leaf byte-equal CPU vs card; worst float relative difference "
        f"{worst_rel:.3g}")

    # 5. result
    kernels = [{
        "name": "pack_groups_batched",
        "route": "cuda",
        "source": "kubernetes_autoscaler_tpu_torch/csrc/pack.cu",
        "replaces": "kubernetes_autoscaler_tpu/ops/pallas/pack_kernel.py:198",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "checked": True,
        "shapes": "filter B=1 + options B=NG per step; ms are per step",
    }]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

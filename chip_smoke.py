#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py [--profile DIR]

Phases, in order; any failure exits non-zero and no phase carries on past
its own failure:

  1. device     the card's name and power limit (nvidia-smi); no CUDA → exit 1
  2. build      every CUDA source of the port, built with nvcc in parallel
  3. kernels    each kernel (K1 pack.cu, K2 wavefront.cu) against its plain
                PyTorch version on the card, byte for byte, on seeded cases
  4. main       `run_once_fused` on the bench world (5,000 nodes, 50,000
                pending pods in 25 groups, 40,000 residents, 20 node groups):
                step and phase times, launches per step, peak memory,
                invariants, and with --profile device time by kernel and the
                device's busy share; K1 on the inputs the path gives it and
                its times there
  5. wavefront  the phased scale-up with a wavefront plan on the
                pool-partitioned bench world (5 pools of 1,000 nodes, each
                pending group pinned to one pool): plan time and plane fetch
                bytes, the cache hit on count churn, W on the other worlds,
                `scale_up_sim` with and without the plan, alternating step
                by step (launches per step, step times, the paired
                difference, every leaf byte-equal), K2 on the path's inputs
                and its times beside K1 at B=1 on the same inputs
  6. phased     `scale_down_sim` and `run_once_sim` on the main world
  7. cpu-card   the same steps on the CPU and on the card at 512 nodes
                (fused and run_once_sim on the residents world, scale_up_sim
                with the plan on the partitioned world): every integer and
                bool leaf byte-equal, float leaves within rtol 1e-5
  8. result     the kernels line, the card line, and the last line
                {"ok": true, "device": {...}}

Imports nothing of JAX and nothing of the JAX package: the worlds are built
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
POOLS = 5                     # node pools of the partitioned world
SMALL_NODES = 512             # the CPU-vs-card comparison worlds
STEPS = 100                   # timed steps of the main path
WAVE_STEPS = 50               # timed steps of each scale_up_sim variant
PHASED_STEPS = 3              # timed steps of scale_down_sim / run_once_sim
REPS = 20                     # timed runs per kernel measurement
HOLD_CYCLES = 2_000_000       # ≈ 1 ms spin, longer than the host takes to enqueue a launch


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3, hold: bool = False) -> float:
    """Median over `reps` runs of fn's time on the card (CUDA events,
    synchronized after each run), after `warmup` runs. With `hold`, a spin
    kernel (torch.cuda._sleep) keeps the stream busy while the host
    enqueues fn, so the events bracket the device work alone; without it
    they also take in the host's time to launch fn (Python, ctypes, the
    allocations), during which the device idles."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, steps: int, warmup: int = 2) -> list[float]:
    """Host-clock times of `steps` calls of fn, each ended by a
    synchronize, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def ptxas_report(log_path):
    """[(kernel, registers, spill line)] from nvcc's -Xptxas -v output; a
    template instance is named by its arguments (<1, 1, 1>)."""
    import re

    out, name, spills = [], None, ""
    for line in log_path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            sym = m.group(1)
            k = re.search(r"\d+([a-z_]+_kernel)", sym)
            args = re.findall(r"L[ib](\d+)E", sym)
            name = (k.group(1) if k else sym) + (
                f"<{', '.join(args)}>" if args else "")
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append((name, int(regs), spills))
            name = None
    return out


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


class Events:
    """The `phases` argument of plan_wavefronts / fetch_pytree: counts."""

    def __init__(self):
        self.events: dict[str, int] = {}

    def bump(self, name: str, n: int = 1) -> None:
        self.events[name] = self.events.get(name, 0) + n


# ---------------------------------------------------------------- worlds


def build_world(n_nodes, n_pods, n_groups, n_nodegroups, residents_per_node,
                device, pools=0, bench_load=False, node_bucket=256,
                group_bucket=64):
    """The bench world (bench.py build_world: same labels, taints, zones,
    GPU nodes, pending groups drawn from RandomState(0), node-group
    templates), then drainability.

    `residents_per_node` adds the scale-down bench's residents (800m / 256
    MiB each, owners rs0..rs16), which carry the nodes' load; `bench_load`
    instead sets bench.py's synthetic load (40 % of cpu and memory, 30 % of
    the pods slot). With `pools` = k the cluster is carved into k node
    pools: node i and template t get pool=p{i % k} / p{t % k} in place of
    the two-valued pool label, and pending group g's selector gains
    pool: p{g % k}."""
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

    def pool(i):
        return f"p{i % pools}" if pools else ("a" if i % 2 else "b")

    rng = np.random.RandomState(0)
    zones = ["us-a", "us-b", "us-c"]
    nodes = []
    for i in range(n_nodes):
        taints = [Taint("dedicated", "infra", "NoSchedule")] if i % 10 == 0 else []
        nodes.append(build_test_node(
            f"node-{i}", cpu_milli=16000, mem_mib=65536, pods=110,
            labels={"pool": pool(i), "disk": "ssd" if i % 3 else "hdd"},
            taints=taints, zone=zones[i % 3], gpus=8 if i % 25 == 0 else 0))
    per_group = n_pods // n_groups
    pods = []
    for g in range(n_groups):
        cpu = int(rng.choice([250, 500, 1000, 2000, 4000]))
        mem = int(rng.choice([256, 512, 2048, 8192]))
        sel = {"disk": "ssd"} if g % 4 == 0 else {}
        if pools:
            sel = {**sel, "pool": pool(g)}
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
    if bench_load:
        cap = enc.nodes.cap.cpu().numpy()
        alloc = cap * 0
        alloc[:, 0] = (cap[:, 0] * 0.4).astype(np.int32)
        alloc[:, 1] = (cap[:, 1] * 0.4).astype(np.int32)
        alloc[:, 3] = (cap[:, 3] * 0.3).astype(np.int32)
        enc.nodes = enc.nodes.replace(alloc=torch.from_numpy(alloc).to(device))
    apply_drainability(enc, now=0.0)
    templates = []
    for t in range(n_nodegroups):
        tmpl = build_test_node(
            f"template-{t}", cpu_milli=[4000, 8000, 16000, 32000][t % 4],
            mem_mib=[16384, 32768, 65536, 131072][t % 4], pods=110,
            labels={"pool": pool(t), "disk": "ssd" if t % 3 else "hdd"},
            zone=zones[t % 3], gpus=8 if t % 5 == 0 else 0)
        templates.append((tmpl, 1000, float(1 + t)))
    groups = encode_node_groups(templates, enc.registry, enc.zone_table,
                                device=device)
    return enc, groups


def describe(enc, groups) -> str:
    return (f"nodes {enc.nodes.n}, pending groups "
            f"{int((enc.specs.count > 0).sum())} of {enc.specs.g} rows "
            f"({int(enc.specs.valid.sum())} valid, "
            f"{int(enc.specs.count.sum())} pods), residents "
            f"{int(enc.scheduled.valid.sum())}, node groups {groups.ng}")


def flat(tree, prefix=""):
    """{path: tensor} over a port result tree (None and int fields skipped)."""
    import dataclasses

    if tree is None or isinstance(tree, int):
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


def assert_finite(name, tree):
    for path, t in flat(tree).items():
        if t.dtype.is_floating_point and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}{path} is not finite")


def compare_cpu_card(name, cpu_tree, card_tree) -> tuple[int, float]:
    """Every int and bool leaf byte-equal, float leaves within rtol 1e-5
    (the card sums in another order, f32, ≤1024 terms). Returns (leaves,
    worst float relative difference)."""
    c_leaves, g_leaves = flat(cpu_tree), flat(card_tree)
    if sorted(c_leaves) != sorted(g_leaves):
        raise AssertionError(f"{name}: the trees differ in structure")
    worst = 0.0
    for path, c in c_leaves.items():
        g = g_leaves[path].cpu()
        if c.dtype != g.dtype or c.shape != g.shape:
            raise AssertionError(f"{name}{path}: dtype/shape differ")
        if c.dtype.is_floating_point:
            if c.numel():
                worst = max(worst, float(((g - c).abs()
                                          / c.abs().clamp(min=1e-30)).max()))
            if not torch.allclose(g, c, rtol=1e-5, atol=0.0):
                raise AssertionError(f"{name}{path}: float leaf differs")
        elif not torch.equal(c, g):
            raise AssertionError(f"{name}{path}: CPU and card differ")
    return len(c_leaves), worst


# ---------------------------------------------------------------- K1 checks


def pack_bound(launch_args, mask):
    """(bound ms, 'bytes'|'operations') of one K1 launch on these inputs, as
    timed (`pack_kernel.launch`: the mask bit-packed, limit_one as int32):
    each input read once, each output written once; operations: 4R integer
    ops (clamp, divide, min, update) per resource on every (row, group,
    lane) whose bit of the bool `mask` is set, plus 8 for the mask test, the
    caps and the scan on every (row, group, lane)."""
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
    err = check_equal(name, got, want)
    log(f"[kernels] pack_groups_batched == plain: {name} "
        f"(B={args[0].shape[0]} G={args[2].shape[0]} N={args[0].shape[1]})")
    return err


def check_equal(name, got, want) -> int:
    """Byte equality of two PackResults; returns the max abs difference."""
    err = 0
    for field in ("placed", "scheduled", "free_after"):
        a, w = getattr(got, field), getattr(want, field)
        if a.dtype != w.dtype or a.shape != w.shape:
            raise AssertionError(f"{name}: {field} {a.dtype}{tuple(a.shape)} "
                                 f"vs {w.dtype}{tuple(w.shape)}")
        err = max(err, int((a.long() - w.long()).abs().max()) if a.numel() else 0)
        if not torch.equal(a, w):
            raise AssertionError(f"{name}: {field} differs from the plain version")
    return err


# ---------------------------------------------------------------- K2 cases


def wave_case(seed, g, n, r=8, style="mixed", max_count=3000,
              limit_share=0.3, device=None):
    """Seeded wavefront-pack inputs [free, mask, req, count, limit_one,
    waves] on `device` (default DEVICE), with the plan built from the mask
    in FFD order. Mask styles as the reference's tests/test_wavefront_pack.py
    generator: "overlap" rows overlap everything, "disjoint" rows take one
    of four node blocks, "sparse" rows are sparse random; "mixed" cycles
    the three."""
    from kubernetes_autoscaler_tpu_torch.ops.pack import (
        build_wavefront_plan,
        ffd_order,
    )

    rng = np.random.default_rng(seed)
    free = rng.integers(0, 40, size=(n, r)).astype(np.int32)
    req = rng.integers(0, 6, size=(g, r)).astype(np.int32)
    req[0] = 0                                     # a zero-request group
    count = rng.integers(0, max_count, size=(g,)).astype(np.int32)
    mask = np.zeros((g, n), bool)
    for gi in range(g):
        kind = style if style != "mixed" else ("overlap", "disjoint",
                                               "sparse")[gi % 3]
        if kind == "overlap":
            mask[gi] = rng.random(n) < 0.6
        elif kind == "disjoint":
            blk = gi % 4
            mask[gi, blk * (n // 4):(blk + 1) * (n // 4)] = True
        else:
            mask[gi] = rng.random(n) < 0.2
    limit_one = rng.random(g) < limit_share
    order = ffd_order(torch.from_numpy(req), torch.ones((g,), dtype=torch.bool))
    dev = device or DEVICE
    waves = build_wavefront_plan(mask, order.numpy(), device=dev).waves
    return [torch.from_numpy(a).to(dev)
            for a in (free, mask, req, count, limit_one)] + [waves]


def wave_cases(device=None):
    from kubernetes_autoscaler_tpu_torch.ops.pack import (
        build_wavefront_plan,
        ffd_order,
    )

    device = device or DEVICE

    def case(*a, **kw):
        return wave_case(*a, device=device, **kw)

    def replan(c, mask):
        order = ffd_order(c[2].cpu(), torch.ones((c[2].shape[0],),
                                                 dtype=torch.bool))
        return build_wavefront_plan(mask.cpu().numpy(), order.numpy(),
                                    device=device).waves

    cases = [(f"fuzzed {style} masks G=64 N=5120", case(s, 64, 5120, style=style))
             for s, style in enumerate(("mixed", "overlap", "disjoint"))]
    one = case(3, 64, 4096, style="disjoint")
    one[1].zero_()
    for gi in range(64):                          # a perfect partition
        one[1][gi, gi * 64:(gi + 1) * 64] = True
    one[5] = replan(one, one[1])
    cases.append(("W == 1: all 64 masks disjoint (more slots than warps)",
                  one))
    full = case(4, 24, 2048)
    full[1].fill_(True)
    full[5] = replan(full, full[1])
    cases.append(("W == G: every mask overlaps every other", full))
    sub = case(5, 48, 3000)
    rng = np.random.default_rng(5)
    keep = torch.from_numpy(rng.random(tuple(sub[1].shape)) < 0.7).to(device)
    sub[1] = sub[1] & keep                        # plan built from the superset
    cases.append(("runtime mask a strict subset of the plan mask", sub))
    ovl = case(6, 40, 1500, style="overlap")
    ovl[5] = torch.arange(40, dtype=torch.int32, device=device).reshape(5, 8)
    cases.append(("plan with overlapping slots (segmented semantics)", ovl))
    cases.append(("every group limit_one", case(7, 16, 700, limit_share=1.0)))
    neg = case(14, 24, 2000, style="disjoint")
    neg[3][::3] = -neg[3][::3] - 1                # the formula's result
    cases.append(("negative counts (delta path)", neg))
    z = case(8, 3, 200, style="overlap")
    z[0].zero_()
    z[2].zero_()
    z[3] = torch.tensor([7, 0, 2 ** 30], dtype=torch.int32, device=device)
    cases.append(("zero-request groups on empty nodes", z))
    b31 = case(9, 32, 300)
    b31[1].zero_()
    b31[1][31, :] = True
    b31[5] = replan(b31, b31[1])
    cases.append(("only group 31 (the sign bit) feasible", b31))
    cases.append(("G=33 (two mask words)", case(10, 33, 512)))
    cases.append(("N=1031, not a multiple of a warp", case(11, 12, 1031)))
    cases.append(("N=40", case(12, 5, 40)))
    cases.append(("N=8192: free plane in device memory", case(13, 40, 8192)))
    return cases


def wave_bound(launch_args, mask):
    """(bound ms, 'bytes'|'operations') of one K2 launch on these inputs, as
    timed (`wavefront_kernel.launch`: the mask bit-packed, limit_one as
    int32): each input read once, each output written once; operations, for
    the slots this data makes live (a group in the plan with a count > 0):
    4R integer ops per resource on every lane whose mask bit is set plus 8
    on every lane."""
    free, req, count, waves = launch_args[0], launch_args[2], launch_args[3], \
        launch_args[5]
    n, r = free.shape
    g = req.shape[0]
    in_bytes = sum(t.numel() * t.element_size() for t in launch_args)
    out_bytes = (g * n + n * r + g) * 4               # placed, free_after, scheduled
    t_bytes = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
    ids = waves[waves >= 0].long()
    live = ids[count[ids] > 0]
    ops = int(mask[live].sum()) * 4 * r + int(live.numel()) * n * 8
    t_ops = ops / H100_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_wave(name, args, kernel, plain):
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = check_equal(name, got, want)
    log(f"[kernels] pack_groups_wavefront == plain: {name} "
        f"(G={args[2].shape[0]} N={args[0].shape[0]} "
        f"waves {tuple(args[5].shape)})")
    return err


# ---------------------------------------------------------------- profile


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


# ---------------------------------------------------------------- phases


def main_phase(args, dims, kernel, plain):
    """Phase 4: the fused step on the main world. Returns (world, K1
    launches, K1 entry fields, max abs err)."""
    from kubernetes_autoscaler_tpu_torch.ops import autoscale_step, drain
    from kubernetes_autoscaler_tpu_torch.ops.binpack import option_pack_inputs
    from kubernetes_autoscaler_tpu_torch.ops.kernels import pack_kernel
    from kubernetes_autoscaler_tpu_torch.ops.schedule import filter_pack_inputs

    t0 = time.perf_counter()
    enc, groups = build_world(NODES, PODS, POD_GROUPS, NODEGROUPS,
                              RESIDENTS_PER_NODE, DEVICE)
    log(f"[main] world encoded in {time.perf_counter() - t0:.1f} s: "
        f"{describe(enc, groups)} (real nodes {NODES}), max_new_nodes "
        f"{MAX_NEW_NODES}, max_pods_per_node {MAX_PODS_PER_NODE}, drain chunk "
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
    assert_finite("[main]", (decision, resident))
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
    ms = device_ms = plain_ms = bound_ms = 0.0
    bound_by = "bytes"
    max_err = 0
    for name, a in shapes.items():
        max_err = max(max_err, check_pack(f"main-path {name} inputs", a,
                                          kernel, plain))
        t = k1_times(a, kernel, plain)
        b, n, r = a[0].shape
        log(f"[kernels] pack_groups_batched {name} B={b} G={a[2].shape[0]} "
            f"N={n} R={r} (at most {t['live_groups']} live groups a row): "
            f"{k1_line(t)}")
        ms, device_ms = ms + t["launch"], device_ms + t["kernel"]
        plain_ms += t["plain"]
        bound_ms += t["bound"]
        if t["bound_by"] == "operations":
            bound_by = "operations"
    entry = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by}
    return (enc, groups), launches, entry, max_err


def k1_times(a, kernel, plain):
    """K1's times on the wrapper arguments `a` (free, mask, req, count,
    order, limit_one): the kernel's device time, as launched from Python,
    with every mask bit clear (serial depth) and with the free plane zero
    (live-group depth); the wrapper's and the plain version's time; the
    bound; the most live groups of a row."""
    from kubernetes_autoscaler_tpu_torch.ops.bitplane import pack_group_bits
    from kubernetes_autoscaler_tpu_torch.ops.kernels import pack_kernel

    bits = (a[0], pack_group_bits(a[1]), *a[2:5], a[5].to(torch.int32))
    t = {"kernel": cuda_ms(lambda: pack_kernel.launch(*bits), REPS, hold=True),
         "launch": cuda_ms(lambda: pack_kernel.launch(*bits), REPS)}
    # every mask bit clear: no lane fits, so no group with a positive count
    # is live; what is left is the staging, the dead rows and negative counts
    no_fit = (bits[0], torch.zeros_like(bits[1]), *bits[2:])
    t["depth"] = cuda_ms(lambda: pack_kernel.launch(*no_fit), REPS, hold=True)
    # the free plane zero: every group with a count and a mask bit stays
    # live and takes its scan and barrier, but no lane has room for a request
    no_room = (torch.zeros_like(bits[0]), *bits[1:])
    t["live"] = cuda_ms(lambda: pack_kernel.launch(*no_room), REPS, hold=True)
    t["wrapper"] = cuda_ms(lambda: kernel(*a), REPS)
    t["plain"] = cuda_ms(lambda: plain(*a), REPS)
    t["bound"], t["bound_by"] = pack_bound(bits, a[1])
    t["live_groups"] = int(((a[3] > 0)[None, :] & a[1].any(dim=2)).sum(dim=1).max())
    return t


def k1_line(t) -> str:
    return (f"kernel {t['kernel']} ms (device time; {t['launch']} ms as "
            f"launched from Python), every mask bit clear (serial depth) "
            f"{t['depth']} ms, free plane zero (live-group depth) {t['live']} "
            f"ms, wrapper with mask packing {t['wrapper']} ms, plain "
            f"{t['plain']} ms, bound {t['bound']} ms ({t['bound_by']})")


def wavefront_phase(dims, main_world):
    """Phase 5: the phased scale-up with and without a wavefront plan on
    the pool-partitioned world. Returns (K2 launches, K2 entry fields, max
    abs err)."""
    from kubernetes_autoscaler_tpu_torch.ops import autoscale_step
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

    k2 = wavefront_kernel.pack_groups_wavefront
    k1 = pack_kernel.pack_groups_batched

    # W on the other worlds: bench.py's own (no residents, its synthetic
    # load), the main world, and the partitioned world with residents
    for name, world in (
            ("bench world", lambda: build_world(
                NODES, PODS, POD_GROUPS, NODEGROUPS, 0, DEVICE,
                bench_load=True)),
            ("main world (bench + residents)", lambda: main_world),
            ("partitioned world + residents", lambda: build_world(
                NODES, PODS, POD_GROUPS, NODEGROUPS, RESIDENTS_PER_NODE,
                DEVICE, pools=POOLS))):
        e, _ = world()
        p = plan_wavefronts(e.nodes, e.specs, WavefrontCache())
        log(f"[wavefront] {name}: W={p.n_waves} of {p.n_active} active "
            f"groups, worthwhile={p.worthwhile}, waves {tuple(p.waves.shape)}")

    t0 = time.perf_counter()
    enc, groups = build_world(NODES, PODS, POD_GROUPS, NODEGROUPS, 0, DEVICE,
                              pools=POOLS, bench_load=True)
    log(f"[wavefront] partitioned world encoded in "
        f"{time.perf_counter() - t0:.1f} s: {describe(enc, groups)}, "
        f"{POOLS} pools, bench load, max_new_nodes {MAX_NEW_NODES}")
    cache = WavefrontCache()
    ev = Events()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = plan_wavefronts(enc.nodes, enc.specs, cache, phases=ev)
    plan_ms = (time.perf_counter() - t0) * 1e3
    moved = ev.events["batched_fetch_bytes_moved"]
    logical = ev.events["batched_fetch_bytes_logical"]
    log(f"[wavefront] partitioned world: W={plan.n_waves} of {plan.n_active} "
        f"active groups, worthwhile={plan.worthwhile}, waves "
        f"{tuple(plan.waves.shape)}, wave sizes "
        f"{(plan.waves >= 0).sum(dim=1).tolist()}; plan_wavefronts "
        f"{plan_ms} ms (first call, host clock); plane fetch {moved} B moved "
        f"vs {logical} B logical ({logical / moved}x)")
    if not plan.worthwhile:
        raise AssertionError("the partitioned world's plan is not worthwhile")
    t0 = time.perf_counter()
    again = plan_wavefronts(enc.nodes, enc.specs.replace(
        count=enc.specs.count + 1), cache)
    log(f"[wavefront] every count raised by one: cache hits {cache.hits}, "
        f"misses {cache.misses} ({(time.perf_counter() - t0) * 1e3} ms)")
    if again is not plan or (cache.hits, cache.misses) != (1, 1):
        raise AssertionError("count churn missed the wavefront cache")

    def sim(with_plan):
        return autoscale_step.scale_up_sim(
            enc.nodes, enc.specs, enc.scheduled, groups, dims,
            max_new_nodes=MAX_NEW_NODES,
            wavefront_plan=plan if with_plan else None)

    # the two variants alternate step by step (which one goes first flips
    # every pair), so both see the same conditions; launches are read per
    # call, and the counts are zeroed just before the path and read after
    for with_plan in (True, False):                      # warm-up
        sim(with_plan)
    torch.cuda.synchronize()
    k1.launches = k2.launches = 0
    times = {True: [], False: []}
    per_call = {True: set(), False: set()}
    for i in range(WAVE_STEPS):
        for with_plan in ((True, False) if i % 2 == 0 else (False, True)):
            before = (k1.launches, k2.launches)
            t0 = time.perf_counter()
            sim(with_plan)
            torch.cuda.synchronize()
            times[with_plan].append((time.perf_counter() - t0) * 1e3)
            per_call[with_plan].add((k1.launches - before[0],
                                     k2.launches - before[1]))
    counts = (k1.launches, k2.launches)
    for with_plan in (True, False):
        label = "with the plan" if with_plan else "without a plan"
        log(f"[wavefront] scale_up_sim {label}: step ms over {WAVE_STEPS} "
            f"steps p50 {pct(times[with_plan], 50)} p90 "
            f"{pct(times[with_plan], 90)}; launches K1, K2 per step "
            f"{sorted(per_call[with_plan])}")
    diff = [a - b for a, b in zip(times[True], times[False])]
    log(f"[wavefront] paired steps (with - without): median {pct(diff, 50)} ms, "
        f"with the plan faster in {sum(d < 0 for d in diff)} of {len(diff)} "
        f"pairs; launches in the path K1 {counts[0]}, K2 {counts[1]}")
    if per_call[True] != {(1, 1)}:
        raise AssertionError(f"expected 1 K1 and 1 K2 launch per step with "
                             f"the plan, got {per_call[True]}")
    if per_call[False] != {(2, 0)}:
        raise AssertionError(f"expected 2 K1 launches per step without a "
                             f"plan, got {per_call[False]}")
    results = {with_plan: sim(with_plan) for with_plan in (True, False)}
    torch.cuda.synchronize()
    with_p, without = flat(results[True]), flat(results[False])
    for path, t in with_p.items():
        if not torch.equal(t, without[path]):
            raise AssertionError(f"scale_up_sim{path} differs with the plan")
    up = results[True]
    assert_finite("[wavefront]", up)
    log(f"[wavefront] {len(with_p)} leaves byte-equal with and without the "
        f"plan: fits existing {int(up.fits_existing.sum())}, remaining "
        f"{int(up.remaining.sum())}, options valid "
        f"{int(up.scores.valid.sum())}, best {int(up.best)}")

    # K2 on the path's own inputs, and K1 at B=1 on the same inputs
    free, mask, req, count, order, limit_one = filter_pack_inputs(
        enc.nodes, enc.specs, enc.scheduled)
    a = [free, mask, req, count, limit_one, plan.waves]
    max_err = check_wave("partitioned-world filter inputs", a,
                         k2, wavefront_kernel.pack_groups_wavefront_plain)
    bits = (free, pack_group_bits(mask), req, count,
            limit_one.to(torch.int32), plan.waves)
    k_ms = cuda_ms(lambda: wavefront_kernel.launch(*bits), REPS, hold=True)
    launch_ms = cuda_ms(lambda: wavefront_kernel.launch(*bits), REPS)
    no_fit = (free, torch.zeros_like(bits[1]), *bits[2:])
    depth_ms = cuda_ms(lambda: wavefront_kernel.launch(*no_fit), REPS,
                       hold=True)
    w_ms = cuda_ms(lambda: k2(*a), REPS)
    p_ms = cuda_ms(lambda: wavefront_kernel.pack_groups_wavefront_plain(*a),
                   REPS)
    bnd, by = wave_bound(bits, mask)
    n, r = free.shape
    log(f"[kernels] pack_groups_wavefront filter G={req.shape[0]} N={n} R={r} "
        f"waves {tuple(plan.waves.shape)} (W={plan.n_waves}): kernel {k_ms} "
        f"ms (device time; {launch_ms} ms as launched from Python), kernel "
        f"with no lane fitting (serial depth) {depth_ms} ms, "
        f"wrapper with checks and mask packing {w_ms} ms, plain {p_ms} ms, "
        f"bound {bnd} ms ({by})")
    k1_args = [free[None].contiguous(), mask[None].contiguous(), req, count,
               order, limit_one]
    max_err = max(max_err, check_pack("partitioned-world filter inputs",
                                      k1_args, k1,
                                      pack_kernel.pack_groups_batched_plain))
    t = k1_times(k1_args, k1, pack_kernel.pack_groups_batched_plain)
    log(f"[kernels] pack_groups_batched on the same inputs (B=1, "
        f"G={req.shape[0]} serial groups, {t['live_groups']} live): "
        f"{k1_line(t)}; K2 / K1 kernel time {k_ms / t['kernel']}")
    entry = {"ms": launch_ms, "device_ms": k_ms, "plain_ms": p_ms,
             "bound_ms": bnd, "bound_by": by}
    return counts[1], entry, max_err


def phased_phase(dims, world):
    """Phase 6: scale_down_sim and run_once_sim on the main world."""
    from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
        ClusterTensors,
    )
    from kubernetes_autoscaler_tpu_torch.ops import autoscale_step

    enc, groups = world
    cluster = ClusterTensors(nodes=enc.nodes, pending=enc.specs,
                             scheduled=enc.scheduled, groups=groups)
    out = {}

    def down():
        out["down"] = autoscale_step.scale_down_sim(
            enc.nodes, enc.specs, enc.scheduled,
            max_pods_per_node=MAX_PODS_PER_NODE)

    def once():
        out["once"] = autoscale_step.run_once_sim(
            cluster, dims, max_new_nodes=MAX_NEW_NODES,
            max_pods_per_node=MAX_PODS_PER_NODE)

    for name, fn in (("scale_down_sim", down), ("run_once_sim", once)):
        ms = host_ms(fn, PHASED_STEPS, warmup=1)
        log(f"[phased] {name} step ms over {PHASED_STEPS} steps: {ms}")
    sd = out["down"]
    up, down2 = out["once"]
    assert_finite("[phased]", (sd, up, down2))
    down2 = flat(down2)
    for path, t in flat(sd).items():
        if not torch.equal(t, down2[path]):
            raise AssertionError(f"scale_down_sim{path} differs in run_once_sim")
    log(f"[phased] eligible {int(sd.eligible.sum())}, drainable "
        f"{int(sd.removal.drainable.sum())}, blocked "
        f"{int(sd.removal.has_blocker.sum())}; run_once_sim fits existing "
        f"{int(up.fits_existing.sum())}, best {int(up.best)}")


def cpu_card_phase(dims):
    """Phase 7: the same steps on the CPU and on the card at 512 nodes."""
    from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
        ClusterTensors,
    )
    from kubernetes_autoscaler_tpu_torch.ops import autoscale_step
    from kubernetes_autoscaler_tpu_torch.ops.pack import WavefrontCache
    from kubernetes_autoscaler_tpu_torch.ops.schedule import plan_wavefronts

    pods = PODS * SMALL_NODES // NODES
    runs = {}
    for dev in ("cpu", DEVICE):
        e, gr = build_world(SMALL_NODES, pods, POD_GROUPS, NODEGROUPS,
                            RESIDENTS_PER_NODE, dev)
        cap = torch.full((gr.ng,), MAX_NEW_NODES, dtype=torch.int32,
                         device=dev)
        fused = autoscale_step.run_once_fused(
            e.nodes, e.specs, e.scheduled, gr, cap, dims,
            max_new_nodes=MAX_NEW_NODES, max_pods_per_node=MAX_PODS_PER_NODE)
        once = autoscale_step.run_once_sim(
            ClusterTensors(nodes=e.nodes, pending=e.specs,
                           scheduled=e.scheduled, groups=gr),
            dims, max_new_nodes=MAX_NEW_NODES,
            max_pods_per_node=MAX_PODS_PER_NODE)
        pe, pg = build_world(SMALL_NODES, pods, POD_GROUPS, NODEGROUPS, 0, dev,
                             pools=POOLS, bench_load=True)
        plan = plan_wavefronts(pe.nodes, pe.specs, WavefrontCache())
        if not plan.worthwhile:
            raise AssertionError(f"512-node partitioned plan on {dev} is not "
                                 f"worthwhile")
        up = autoscale_step.scale_up_sim(
            pe.nodes, pe.specs, pe.scheduled, pg, dims,
            max_new_nodes=MAX_NEW_NODES, wavefront_plan=plan)
        runs[dev] = {"run_once_fused": fused, "run_once_sim": once,
                     "scale_up_sim with the plan": up, "plan": plan.waves}
    if not torch.equal(runs["cpu"]["plan"], runs[DEVICE]["plan"].cpu()):
        raise AssertionError("512-node plans differ between CPU and card")
    for name in ("run_once_fused", "run_once_sim", "scale_up_sim with the plan"):
        n_leaves, worst = compare_cpu_card(f"512-node {name}",
                                           runs["cpu"][name],
                                           runs[DEVICE][name])
        log(f"[cpu-card] 512-node {name}: {n_leaves} leaves, every int and "
            f"bool leaf byte-equal CPU vs card; worst float relative "
            f"difference {worst:.3g}")


# ---------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one fused step; the trace goes to DIR")
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the port itself: without the repo around this script, this fails here,
    # before anything is printed
    from kubernetes_autoscaler_tpu_torch.models.cluster_state import Dims
    from kubernetes_autoscaler_tpu_torch.ops.kernels import (
        build,
        pack_cases,
        pack_kernel,
        wavefront_kernel,
    )

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{kind} x{torch.cuda.device_count()}")

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = build.build([pack_kernel.SOURCE, wavefront_kernel.SOURCE])
    log(f"[build] {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    for source, lib in libs.items():
        for name, regs, spills in ptxas_report(lib.with_suffix(".log")):
            log(f"[build] {source} {name}: {regs} registers, {spills}")

    k1, k1_plain = (pack_kernel.pack_groups_batched,
                    pack_kernel.pack_groups_batched_plain)
    k2, k2_plain = (wavefront_kernel.pack_groups_wavefront,
                    wavefront_kernel.pack_groups_wavefront_plain)

    # 3. kernels against their plain versions on seeded cases
    k1_err = k2_err = 0
    for name, case in pack_cases.CASES.items():
        k1_err = max(k1_err, check_pack(
            name, [a.to(DEVICE) for a in case()], k1, k1_plain))
    for name, case in wave_cases():
        k2_err = max(k2_err, check_wave(name, case, k2, k2_plain))

    dims = Dims()
    # 4. the fused main path at full size
    world, k1_launches, k1_entry, err = main_phase(args, dims, k1, k1_plain)
    k1_err = max(k1_err, err)
    # 5. the wavefront path at full size
    k2_launches, k2_entry, err = wavefront_phase(dims, world)
    k2_err = max(k2_err, err)
    # 6. the phased scale-down and run_once_sim on the main world
    phased_phase(dims, world)
    # 7. CPU against the card at 512 nodes
    cpu_card_phase(dims)

    # 8. result: `ms` is the kernel as launched from Python (CUDA events
    # around the launch call, the host's enqueue included), `device_ms` the
    # same launch with the stream held while the host enqueues it
    kernels = [{
        "name": "pack_groups_batched",
        "route": "cuda",
        "source": "kubernetes_autoscaler_tpu_torch/csrc/pack.cu",
        "replaces": "kubernetes_autoscaler_tpu/ops/pallas/pack_kernel.py:198",
        "launches": k1_launches,
        "max_abs_err": k1_err,
        **k1_entry,
        "library_ms": None,
        "checked": True,
        "shapes": "run_once_fused: filter B=1 + options B=NG per step; "
                  "ms are per step",
    }, {
        "name": "pack_groups_wavefront",
        "route": "cuda",
        "source": "kubernetes_autoscaler_tpu_torch/csrc/wavefront.cu",
        "replaces": "kubernetes_autoscaler_tpu/ops/pallas/pack_kernel.py:347",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        **k2_entry,
        "library_ms": None,
        "checked": True,
        "shapes": "scale_up_sim with a wavefront plan: the filter pack on the "
                  "partitioned world, one launch per step",
    }]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py [--profile DIR]

Phases, in order; any failure exits non-zero and no phase carries on past
its own failure:

  1. device     the card's name and power limit (nvidia-smi); no CUDA → exit 1
  2. build      every CUDA source of the port, built with nvcc in parallel,
                and the native confirmation's host library
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
  8. loop       the control loop, `StaticAutoscaler.run_once`, on the card
                at bench.py bench_runonce_e2e's world and options (5,000
                nodes with 2 residents each, 50,000 pending pods in 25
                owner groups; per loop 500 pods churned and 50 bound, a
                200-pod 14,000m burst every fourth loop): one cold loop,
                then 8 timed loops — loop times, phase totals, per loop the
                fused mode, speculation outcome, round trips, encode mode,
                world-store h2d bytes, K1 launches, the host time of the
                speculative dispatch and how long the device stayed busy
                with a discarded speculative program; K1 on the loop's
                inputs against its plain version; with --profile the
                host side of 4 more loops under cProfile (the functions by
                cumulative and by own time; the stats go to
                DIR/loop.pstats) and one loop under torch.profiler (device
                kernels, their time, and the device's busy share of that
                loop's own wall time)
  9. loop-cpu-card  the same churn script on a 512-node world, 8 loops on
                the CPU and 8 on the card: every loop's decision-surface
                digests, fused mode, speculation outcome and round trips
                equal
 10. constrained  `run_once_fused` with the constrained tier on the main
                world with BASELINE.json config #5's constraints (20 of the
                25 pending groups: zone spread, hostname spread, hostname
                anti-affinity and zone affinity to residents): step and
                phase times, waves and flag reads per phase, one step under
                torch.profiler, peak memory, the decision; the wave-check
                interval swept (outputs byte-equal); `run_once_sim` with
                constraints
 11. constrained-cpu-card  a 512-node world with every constraint kind:
                `run_once_fused`, `scale_up_sim` and `scale_down_sim` with
                constraints on the CPU and on the card, leaves equal as in
                7, the same chosen option, a group capped at MAX_WAVES
 12. loop-constrained  the control loop on the constrained main world with
                the churn of 8: a cold loop, 4 timed; fused, at most 2
                round trips, the native confirmation available
 13. loop-constrained-cpu-card  that loop world at 512 nodes with unneeded
                time 0, 8 loops on the CPU and 8 on the card: digests equal
                every loop, nodes deleted, the native confirmation ran
 14. result     the kernels line, the card line, and the last line
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
# the control loop's world: bench.py bench_runonce_e2e at its defaults
LOOP_NODES = 5000
LOOP_PODS = 50000
LOOP_POD_GROUPS = 25
LOOP_CHURN = 500              # pods removed and added before each loop
LOOP_BINDS = 50               # of those, bound to a node by the "kubelet"
LOOP_BURST = 200              # 14,000m pods on loops where loop % 4 == 2
LOOP_STEPS = 8                # timed loops after the cold one
LOOP_SMALL_NODES = 512        # the CPU-vs-card loop world
# the constrained tier: the bench world with constraints (bench_pod_factory)
CON_STEPS = 10                # timed constrained fused steps
CON_PHASED_STEPS = 3          # timed run_once_sim steps with constraints
WAVE_CHECKS = (1, 2, 4, 8, 16)  # wave-check intervals swept
WAVE_ROUNDS = 3               # interleaved rounds of the sweep, one step each
CON_LOOP_STEPS = 4            # timed constrained loops after the cold one
CON_LOOP_SMALL_PODS = 250     # pending pods of the 512-node constrained loop
KINDS_WAVE_PODS = 140         # the every-kind world's one-zone spread group
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


ZONES = ["us-a", "us-b", "us-c"]
ZONE_KEY = "topology.kubernetes.io/zone"
HOST_KEY = "kubernetes.io/hostname"


def bench_pod_factory(n_groups, pools=0, constrained=False):
    """bench.py's pending groups (requests, selectors, tolerations and GPUs
    drawn from RandomState(0)): a function (g, name) → a pending pod of
    group g. With `constrained` (BASELINE.json config #5's anti-affinity
    shape), 20 of every 25 groups carry a topology constraint, by g % 5:
    1 zone spread maxSkew 1 and 2 hostname spread maxSkew 2, each
    selecting the group's own label; 3 required hostname anti-affinity to
    the `app: a3` residents; 4 required zone pod affinity to the `app: a4`
    residents."""
    from kubernetes_autoscaler_tpu_torch.models.api import (
        AffinityTerm,
        Toleration,
        TopologySpreadConstraint,
    )
    from kubernetes_autoscaler_tpu_torch.utils.testing import build_test_pod

    rng = np.random.RandomState(0)
    draws = [(int(rng.choice([250, 500, 1000, 2000, 4000])),
              int(rng.choice([256, 512, 2048, 8192]))) for _ in range(n_groups)]
    tol = [Toleration(key="dedicated", operator="Equal", value="infra",
                      effect="NoSchedule")]
    rules = {
        1: ("topology_spread", TopologySpreadConstraint(
            max_skew=1, topology_key=ZONE_KEY)),
        2: ("topology_spread", TopologySpreadConstraint(
            max_skew=2, topology_key=HOST_KEY)),
        3: ("anti_affinity", AffinityTerm(match_labels={"app": "a3"},
                                          topology_key=HOST_KEY)),
        4: ("pod_affinity", AffinityTerm(match_labels={"app": "a4"},
                                         topology_key=ZONE_KEY)),
    }

    def make(g, name):
        cpu, mem = draws[g]
        sel = {"disk": "ssd"} if g % 4 == 0 else {}
        if pools:
            sel = {**sel, "pool": f"p{g % pools}"}
        p = build_test_pod(
            name, cpu_milli=cpu, mem_mib=mem, owner_name=f"rs-{g}",
            node_selector=sel, tolerations=tol if g % 5 == 0 else [],
            gpus=1 if g % 7 == 0 else 0,
            labels={"grp": f"g{g}"} if constrained else None)
        if constrained and g % 5:
            field, rule = rules[g % 5]
            if field == "topology_spread":
                rule = TopologySpreadConstraint(
                    max_skew=rule.max_skew, topology_key=rule.topology_key,
                    match_labels={"grp": f"g{g}"})
            setattr(p, field, [rule])
        return p

    return make


def bench_objects(n_nodes, n_pods, n_groups, n_nodegroups, residents_per_node,
                  pools=0, constrained=False):
    """(nodes, pods, templates) of the bench world (bench.py build_world:
    same labels, taints, zones, GPU nodes, pending groups, node-group
    templates). `residents_per_node` adds the scale-down bench's residents
    (800m / 256 MiB each, owners rs0..rs16; with `constrained` the
    residents of rs{k} carry `app: a{k % 5}`). With `pools` = k the cluster
    is carved into k node pools: node i and template t get pool=p{i % k} /
    p{t % k} in place of the two-valued pool label, and pending group g's
    selector gains pool: p{g % k}. `constrained`: see bench_pod_factory."""
    from kubernetes_autoscaler_tpu_torch.models.api import Taint
    from kubernetes_autoscaler_tpu_torch.utils.testing import (
        build_test_node,
        build_test_pod,
    )

    def pool(i):
        return f"p{i % pools}" if pools else ("a" if i % 2 else "b")

    nodes = []
    for i in range(n_nodes):
        taints = [Taint("dedicated", "infra", "NoSchedule")] if i % 10 == 0 else []
        nodes.append(build_test_node(
            f"node-{i}", cpu_milli=16000, mem_mib=65536, pods=110,
            labels={"pool": pool(i), "disk": "ssd" if i % 3 else "hdd"},
            taints=taints, zone=ZONES[i % 3], gpus=8 if i % 25 == 0 else 0))
    make = bench_pod_factory(n_groups, pools, constrained)
    per_group = n_pods // n_groups
    pods = [make(g, f"pod-{g}-{i}")
            for g in range(n_groups) for i in range(per_group)]
    k = 0
    for nd in nodes:
        for _ in range(residents_per_node):
            pods.append(build_test_pod(
                f"res-{k}", cpu_milli=800, mem_mib=256,
                owner_name=f"rs{k % 17}", node_name=nd.name,
                labels={"app": f"a{k % 17 % 5}"} if constrained else None))
            k += 1
    templates = []
    for t in range(n_nodegroups):
        tmpl = build_test_node(
            f"template-{t}", cpu_milli=[4000, 8000, 16000, 32000][t % 4],
            mem_mib=[16384, 32768, 65536, 131072][t % 4], pods=110,
            labels={"pool": pool(t), "disk": "ssd" if t % 3 else "hdd"},
            zone=ZONES[t % 3], gpus=8 if t % 5 == 0 else 0)
        templates.append((tmpl, 1000, float(1 + t)))
    return nodes, pods, templates


def encode_world(objects, device, bench_load=False, node_bucket=256,
                 group_bucket=64):
    """Encode (nodes, pods, templates) with the port's encoder, then
    drainability; `bench_load` sets bench.py's synthetic load (40 % of cpu
    and memory, 30 % of the pods slot). Returns (enc, node-group tensors)."""
    from kubernetes_autoscaler_tpu_torch.models.encode import (
        encode_cluster,
        encode_node_groups,
    )
    from kubernetes_autoscaler_tpu_torch.simulator.drainability.rules import (
        apply_drainability,
    )

    nodes, pods, templates = objects
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
    groups = encode_node_groups(templates, enc.registry, enc.zone_table,
                                device=device)
    return enc, groups


def build_world(n_nodes, n_pods, n_groups, n_nodegroups, residents_per_node,
                device, pools=0, bench_load=False, constrained=False):
    """The bench world (bench_objects), encoded (encode_world)."""
    return encode_world(bench_objects(n_nodes, n_pods, n_groups, n_nodegroups,
                                      residents_per_node, pools, constrained),
                        device, bench_load)


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


def profile_step(step, step_ms_p50, out_dir, tag="[profile]",
                 trace_name="chip_smoke_step.trace.json"):
    """One step under torch.profiler: device time by kernel name, the number
    of device kernels, and the device's busy share of an unprofiled step
    (summed kernel time over the step's p50). The trace goes to out_dir
    (none without it). Returns (kernels, kernel ms)."""
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
    log(f"{tag} {kernels} device kernels in one step, {busy_ms} ms of "
        f"kernel time; busy share of the unprofiled step p50 "
        f"{busy_ms / step_ms_p50}")
    for name, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        log(f"{tag} {t} ms {c:6d}x {name[:110]}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, trace_name))
    return kernels, busy_ms


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


# ---------------------------------------------------------------- loop


def loop_world(n_nodes, n_pods):
    """bench.py bench_runonce_e2e's FakeCluster: nodes of 16 CPU / 64 GiB /
    110 pods with two residents each (1,600m on the first 1/16 of the
    nodes, a low-utilization band, 3,200m elsewhere; owners rs0..rs16),
    and `n_pods` pending pods of 500m / 512 MiB in LOOP_POD_GROUPS owner
    groups."""
    from kubernetes_autoscaler_tpu_torch.utils.fakecluster import FakeCluster
    from kubernetes_autoscaler_tpu_torch.utils.testing import (
        build_test_node,
        build_test_pod,
    )

    fake = FakeCluster()
    tmpl = build_test_node("tmpl", cpu_milli=16000, mem_mib=65536, pods=110)
    fake.add_node_group("ng1", tmpl, min_size=0, max_size=4 * n_nodes)
    for i in range(n_nodes):
        nd = build_test_node(f"n{i}", cpu_milli=16000, mem_mib=65536,
                             pods=110)
        fake.add_existing_node("ng1", nd)
        per_pod = 1600 if i < n_nodes // 16 else 3200
        for j in range(2):
            fake.add_pod(build_test_pod(
                f"r{i}-{j}", cpu_milli=per_pod, mem_mib=1024,
                owner_name=f"rs{i % 17}", node_name=nd.name))
    for i in range(n_pods):
        fake.add_pod(loop_pod(i, i))
    return fake


def loop_autoscaler(fake, device, capture_verdicts=False, unneeded_s=3600.0):
    from kubernetes_autoscaler_tpu_torch.config.options import (
        AutoscalingOptions,
        NodeGroupDefaults,
    )
    from kubernetes_autoscaler_tpu_torch.core.static_autoscaler import (
        StaticAutoscaler,
    )
    from kubernetes_autoscaler_tpu_torch.metrics.metrics import Registry

    # an unneeded time of 0 also drops the scale-down delays, so that the
    # planner confirms and deletes nodes from the first loop on
    delays = {} if unneeded_s else dict(scale_down_delay_after_add_s=0.0,
                                        scale_down_delay_after_failure_s=0.0)
    opts = AutoscalingOptions(
        node_shape_bucket=256, group_shape_bucket=64,
        max_new_nodes_static=256, max_pods_per_node=16, drain_chunk=256,
        node_group_defaults=NodeGroupDefaults(
            scale_down_unneeded_time_s=unneeded_s,
            scale_down_unready_time_s=3600.0), **delays)
    a = StaticAutoscaler(fake.provider, fake, options=opts,
                         eviction_sink=fake, registry=Registry(),
                         device=device)
    # the verdict plane feeds the decision digests of [loop-cpu-card]; the
    # timed loops run without it, as bench_runonce_e2e does
    a.capture_verdicts = capture_verdicts
    return a


def loop_pod(seq, k):
    """Pending pod p{seq} of the bench_runonce_e2e world, in owner group
    k % LOOP_POD_GROUPS."""
    from kubernetes_autoscaler_tpu_torch.utils.testing import build_test_pod

    return build_test_pod(f"p{seq}", cpu_milli=500, mem_mib=512,
                          owner_name=f"prs{k % LOOP_POD_GROUPS}")


class LoopScript:
    """bench_runonce_e2e's churn: before each loop LOOP_CHURN pending pods
    leave and as many arrive, LOOP_BINDS of the new ones are bound; a
    LOOP_BURST-pod unfittable burst arrives before loops where loop % 4 ==
    2 and leaves after loops where loop % 4 == 3. `make_pod(seq, k)`
    builds pending pod p{seq}, the k-th of the churn; `node_name(i)` names
    node i."""

    def __init__(self, fake, n_nodes, n_pods, make_pod=loop_pod,
                 node_name="n{}".format):
        self.fake, self.n_nodes, self.n_pods = fake, n_nodes, n_pods
        self.make_pod, self.node_name = make_pod, node_name
        self.seq = self.burst = 0

    def before(self, loop):
        from kubernetes_autoscaler_tpu_torch.utils.testing import (
            build_test_pod,
        )

        churn = min(LOOP_CHURN, self.n_pods)
        for k in range(churn):
            self.fake.remove_pod(f"p{self.seq + k}")
            self.fake.add_pod(self.make_pod(self.n_pods + self.seq + k,
                                            self.seq + k))
        for k in range(min(LOOP_BINDS, churn)):
            self.fake.bind(f"p{self.n_pods + self.seq + k}",
                           self.node_name((self.seq + k) % self.n_nodes))
        self.seq += churn
        if loop % 4 == 2:
            self.burst += 1
            for k in range(LOOP_BURST):
                self.fake.add_pod(build_test_pod(
                    f"burst{self.burst}-{k}", cpu_milli=14000, mem_mib=4096,
                    owner_name=f"burst-rs{self.burst}"))

    def after(self, loop):
        if loop % 4 == 3 and self.burst:
            for k in range(LOOP_BURST):
                self.fake.remove_pod(f"burst{self.burst}-{k}")


def loop_surfaces(a, st) -> dict:
    from kubernetes_autoscaler_tpu_torch.replay import journal

    return {"digests": journal.surface_digests(
                journal.collect_outputs(a, st)),
            "fused_mode": st.fused_mode, "speculation": st.speculation,
            "round_trips": st.loop_device_round_trips}


def loop_phase(card, dims, kernel, plain, profile_dir=None):
    """Phase 8: the control loop on the card at the bench_runonce_e2e
    world, then, with `profile_dir`, the loop's profile. Returns (K1
    launches in the timed loops, per-loop launches, max abs err of K1 on
    the loop's inputs)."""
    from kubernetes_autoscaler_tpu_torch.ops.binpack import option_pack_inputs
    from kubernetes_autoscaler_tpu_torch.ops.kernels import pack_kernel
    from kubernetes_autoscaler_tpu_torch.ops.schedule import filter_pack_inputs

    t0 = time.perf_counter()
    fake = loop_world(LOOP_NODES, LOOP_PODS)
    a = loop_autoscaler(fake, DEVICE)
    log(f"[loop] world built in {time.perf_counter() - t0:.1f} s: "
        f"{LOOP_NODES} nodes, {2 * LOOP_NODES} residents, {LOOP_PODS} pending "
        f"pods in {LOOP_POD_GROUPS} groups ({card})")
    script = LoopScript(fake, LOOP_NODES, LOOP_PODS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = a.run_once(now=1000.0)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    log(f"[loop] cold loop {cold_s} s: fused_mode {st.fused_mode}, encode "
        f"{a._world_store.last_mode}/{a._world_store.last_cause}, pending "
        f"{st.pending_pods} ({card})")
    a.planner.phases.reset()
    compiles = a.metrics.counter("fused_program_compiles_total").value()
    hist = a.metrics.histogram("function_duration_seconds")
    spec_key = (("function", "speculative_dispatch"),)
    sums0 = {k[0][1]: v for k, v in hist._sums.items()}
    torch.cuda.reset_peak_memory_stats()
    side = torch.cuda.Stream()
    ms, rows = [], []
    pack_kernel.pack_groups_batched.launches = 0
    for loop in range(LOOP_STEPS):
        script.before(loop)
        armed = a._speculation is not None
        # the discarded-speculation wait: an event on an idle side stream
        # fires as the loop begins, one on the loop's stream fires once the
        # speculative program queued ahead of the loop has finished
        e_begin = torch.cuda.Event(enable_timing=True)
        e_free = torch.cuda.Event(enable_timing=True)
        e_begin.record(side)
        e_free.record(torch.cuda.current_stream())
        k0 = pack_kernel.pack_groups_batched.launches
        s0 = hist._sums.get(spec_key, 0.0)
        t0 = time.perf_counter()
        st = a.run_once(now=1010.0 + 10.0 * loop)
        ms.append((time.perf_counter() - t0) * 1e3)
        spec_issue_ms = (hist._sums.get(spec_key, 0.0) - s0) * 1e3
        e_free.synchronize()
        busy = e_begin.elapsed_time(e_free) if armed else 0.0
        rows.append({
            "loop": loop, "ms": ms[-1], "fused_mode": st.fused_mode,
            "speculation": st.speculation,
            "round_trips": st.loop_device_round_trips,
            "encode": f"{a._world_store.last_mode}/{a._world_store.last_cause}",
            "h2d_bytes": a._world_store.last_h2d_bytes,
            "k1_launches": pack_kernel.pack_groups_batched.launches - k0,
            "spec_busy_ms": busy, "spec_issue_ms": spec_issue_ms,
            "scaled_up": bool(st.scale_up is not None
                              and st.scale_up.scaled_up),
            "pending": st.pending_pods, "unneeded": len(st.unneeded_nodes)})
        script.after(loop)
    torch.cuda.synchronize()
    launches = pack_kernel.pack_groups_batched.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    for r in rows:
        log(f"[loop] loop {r['loop']}: {r['ms']} ms, fused_mode "
            f"{r['fused_mode']}, speculation {r['speculation']}, round trips "
            f"{r['round_trips']}, encode {r['encode']}, world-store h2d "
            f"{r['h2d_bytes']} B, K1 launches {r['k1_launches']}, "
            f"speculative dispatch issued in {r['spec_issue_ms']} ms of host "
            f"time, device busy "
            f"with the {'discarded' if r['speculation'] == 'discard' else 'harvested' if r['speculation'] == 'hit' else 'no'}"
            f" speculative program for {r['spec_busy_ms']} ms after the loop "
            f"began, scaled up {r['scaled_up']}, pending {r['pending']}, "
            f"unneeded {r['unneeded']} ({card})")
    log(f"[loop] loop ms over {LOOP_STEPS} loops: p50 {pct(ms, 50)} p90 "
        f"{pct(ms, 90)} ({card})")
    sums = {k[0][1]: v - sums0.get(k[0][1], 0.0)
            for k, v in hist._sums.items()}
    total = sum(ms) / 1e3
    for name in ("snapshot_build", "fused_dispatch", "fused_harvest",
                 "filter_out_schedulable", "scale_up", "scale_down_update",
                 "scale_down_confirm", "speculative_dispatch", "main"):
        v = sums.get(name, 0.0)
        log(f"[loop] phase {name} total {v} s over {LOOP_STEPS} loops "
            f"({100.0 * v / total:.1f} % of the loops' time) ({card})")
    log(f"[loop] planner phases: "
        f"{json.dumps(a.planner.phases.snapshot()['totals_ms'])} ({card})")
    log(f"[loop] peak device memory allocated: {peak_mib:.1f} MiB; K1 "
        f"launches {launches} in {LOOP_STEPS} loops ({card})")
    if any(r["fused_mode"] != "fused" for r in rows):
        raise AssertionError("a loop of the default options ran phased")
    if any(r["round_trips"] > 2 for r in rows):
        raise AssertionError("a fused loop took more than 2 round trips")
    if not any(r["scaled_up"] for r in rows):
        raise AssertionError("no loop scaled up for the burst")
    if launches == 0:
        raise AssertionError("the loop launched K1 no time")
    if a.metrics.counter("fused_program_compiles_total").value() != compiles:
        raise AssertionError("the kernel build cache grew after the cold "
                             "loop")

    # K1 on the inputs the loop's last fused dispatch gave it
    ctx = a._fused_ctx
    nodes_t, specs_t, sched_t, _ = ctx["inputs"]
    prep = ctx["prep"]
    filter_args = [x[None].contiguous() if i < 2 else x for i, x in
                   enumerate(filter_pack_inputs(nodes_t, specs_t, sched_t))]
    capped = prep.group_tensors.replace(max_new=torch.minimum(
        prep.group_tensors.max_new, prep.limit_cap_dev))
    option_args, _ = option_pack_inputs(ctx["resident"].specs, capped, dims,
                                        a.options.max_new_nodes_static)
    err = max(check_pack("loop-path filter inputs", filter_args, kernel,
                         plain),
              check_pack("loop-path options inputs", list(option_args),
                         kernel, plain))
    if profile_dir:
        profile_loop(card, a, script, LOOP_STEPS, profile_dir)
    return launches, [r["k1_launches"] for r in rows], err


def loop_cpu_card_phase(card):
    """Phase 9: the churn script on a 512-node world, CPU against card."""
    pods = LOOP_PODS * LOOP_SMALL_NODES // LOOP_NODES
    runs = {}
    for dev in ("cpu", DEVICE):
        fake = loop_world(LOOP_SMALL_NODES, pods)
        a = loop_autoscaler(fake, dev, capture_verdicts=True)
        script = LoopScript(fake, LOOP_SMALL_NODES, pods)
        rows = []
        for loop in range(LOOP_STEPS):
            script.before(loop)
            st = a.run_once(now=1000.0 + 10.0 * loop)
            rows.append(loop_surfaces(a, st))
            script.after(loop)
        runs[dev] = rows
    for loop, (c, g) in enumerate(zip(runs["cpu"], runs[DEVICE])):
        if c != g:
            raise AssertionError(f"[loop-cpu-card] loop {loop}: CPU {c} vs "
                                 f"card {g}")
        log(f"[loop-cpu-card] loop {loop}: digests equal CPU vs card "
            f"({', '.join(f'{k} {v}' for k, v in c['digests'].items())}), "
            f"fused_mode {c['fused_mode']}, speculation {c['speculation']}, "
            f"round trips {c['round_trips']} ({card})")


# ---------------------------------------------------------------- constrained


def constraint_kinds(enc) -> dict:
    """Pending groups (count > 0) by constraint kind, from the encoding."""
    s, pl = enc.specs, enc.planes
    live = s.count > 0
    anti_h = pl.anti_host_cnt.sum(dim=1) > 0
    anti_z = pl.anti_zone_cnt.sum(dim=1) > 0
    kinds = {
        "zone spread": s.spread_kind == 2,
        "hostname spread": s.spread_kind == 1,
        "zone affinity": s.aff_kind == 2,
        "hostname affinity": s.aff_kind == 1,
        "hostname anti-affinity to residents": anti_h,
        "zone anti-affinity to residents": anti_z,
        "hostname self anti-affinity": s.anti_affinity_self,
        "zone self anti-affinity": s.anti_self_zone,
    }
    any_kind = torch.stack(list(kinds.values())).any(dim=0)
    out = {k: int((v & live).sum()) for k, v in kinds.items()}
    out["unconstrained"] = int((~any_kind & live).sum())
    out["host check"] = int((s.needs_host_check & live).sum())
    return out


def kinds_objects(n_nodes):
    """(nodes, pods, templates) of a world with every dense constraint kind
    at `n_nodes` nodes: zone and hostname spread (maxSkew 1 and 2, selecting
    the group itself or only residents), hostname and zone pod affinity
    (satisfied by residents, or self-selecting with the first-pod
    bootstrap), hostname and zone anti-affinity (to residents, and to
    itself, one per node or one per zone), every seventh node without a
    zone, a template without a zone, constrained residents (zone spread,
    hostname and zone self anti-affinity) that the drain re-places, an
    unevictable resident on every ninth node, and a 140-pod zone spread
    pinned to one zone (one pod a wave: it runs into MAX_WAVES)."""
    from kubernetes_autoscaler_tpu_torch.models.api import (
        SAFE_TO_EVICT_KEY,
        AffinityTerm,
        TopologySpreadConstraint,
    )
    from kubernetes_autoscaler_tpu_torch.utils.testing import (
        build_test_node,
        build_test_pod,
    )

    rng = np.random.RandomState(1)
    zones = ["z0", "z1", "z2"]
    nodes = [build_test_node(
        f"n{i}", cpu_milli=int(rng.choice([4000, 8000, 16000])),
        mem_mib=32768, pods=110, labels={"pool": "a" if i % 2 else "b"},
        zone="" if i % 7 == 6 else zones[i % 3]) for i in range(n_nodes)]
    pods = []

    def resident(name, node, app, **extra):
        p = build_test_pod(name, cpu_milli=int(rng.choice([100, 300])),
                           mem_mib=128, node_name=node, labels={"app": app},
                           owner_name=f"rs-{app}")
        for k, v in extra.items():
            setattr(p, k, [v])
        pods.append(p)
        return p

    for i, nd in enumerate(nodes):
        if i % 3 == 0:
            db = resident(f"db{i}", nd.name, "db")
            if i % 9 == 0:
                db.annotations[SAFE_TO_EVICT_KEY] = "false"
        if i % 4 == 1:
            resident(f"cache{i}", nd.name, "cache")
        if i % 5 == 2:
            resident(f"web{i}", nd.name, "web")
        if i % 6 == 4:
            resident(f"sp{i}", nd.name, "sp", topology_spread=(
                TopologySpreadConstraint(max_skew=1, topology_key=ZONE_KEY,
                                         match_labels={"app": "sp"})))
            resident(f"ah{i}", nd.name, "ah", anti_affinity=AffinityTerm(
                match_labels={"app": "ah"}, topology_key=HOST_KEY))
        if i < 3:
            resident(f"az{i}", nd.name, "az", anti_affinity=AffinityTerm(
                match_labels={"app": "az"}, topology_key=ZONE_KEY))
    spread, term = TopologySpreadConstraint, AffinityTerm
    kinds = [
        ("topology_spread", spread(max_skew=1, topology_key=ZONE_KEY,
                                   match_labels={"app": "g0"})),
        ("topology_spread", spread(max_skew=2, topology_key=ZONE_KEY,
                                   match_labels={"app": "g1"})),
        ("topology_spread", spread(max_skew=1, topology_key=HOST_KEY,
                                   match_labels={"app": "g2"})),
        ("topology_spread", spread(max_skew=2, topology_key=HOST_KEY,
                                   match_labels={"app": "db"})),
        ("topology_spread", spread(max_skew=1, topology_key=ZONE_KEY,
                                   match_labels={"app": "cache"})),
        ("pod_affinity", term(match_labels={"app": "db"},
                              topology_key=HOST_KEY)),
        ("pod_affinity", term(match_labels={"app": "cache"},
                              topology_key=ZONE_KEY)),
        ("pod_affinity", term(match_labels={"app": "g7"},
                              topology_key=HOST_KEY)),
        ("pod_affinity", term(match_labels={"app": "g8"},
                              topology_key=ZONE_KEY)),
        ("anti_affinity", term(match_labels={"app": "g9"},
                               topology_key=HOST_KEY)),
        ("anti_affinity", term(match_labels={"app": "g10"},
                               topology_key=ZONE_KEY)),
        ("anti_affinity", term(match_labels={"app": "db"},
                               topology_key=HOST_KEY)),
        ("anti_affinity", term(match_labels={"app": "web"},
                               topology_key=ZONE_KEY)),
        (None, None),
    ]
    per_group = max(4, n_nodes // 8)
    for g, (field, rule) in enumerate(kinds):
        cpu = int(rng.choice([250, 500, 1000]))
        for i in range(per_group):
            p = build_test_pod(f"p{g}-{i}", cpu_milli=cpu, mem_mib=256,
                               owner_name=f"prs{g}", labels={"app": f"g{g}"})
            if field:
                setattr(p, field, [rule])
            pods.append(p)
    for i in range(KINDS_WAVE_PODS):
        p = build_test_pod(f"w{i}", cpu_milli=1, mem_mib=1,
                           owner_name="wave-rs", labels={"app": "wave"},
                           node_selector={ZONE_KEY: zones[0]})
        p.topology_spread = [spread(max_skew=1, topology_key=ZONE_KEY,
                                    match_labels={"app": "wave"})]
        pods.append(p)
    templates = []
    for k in range(4):
        tmpl = build_test_node(
            f"tmpl{k}", cpu_milli=[4000, 8000, 16000, 32000][k],
            mem_mib=65536, pods=110, labels={"pool": "a" if k % 2 else "b"},
            zone=zones[k] if k < 3 else "")
        templates.append((tmpl, 64, float(1 + k)))
    return nodes, pods, templates


def wave_counts():
    from kubernetes_autoscaler_tpu_torch.ops.constrained import place_lanes

    return place_lanes.waves, place_lanes.flag_reads


def constrained_phase(dims, card, profile_dir=None):
    """Phase 10: `run_once_fused` with the constrained tier on the bench
    world with constraints (bench_pod_factory): step and phase times, the
    waves and flag reads of each phase, one step under torch.profiler, peak
    memory, invariants and the decision; the wave-check interval swept
    (outputs byte-equal at every interval); `run_once_sim` with
    constraints."""
    from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
        ClusterTensors,
    )
    from kubernetes_autoscaler_tpu_torch.ops import autoscale_step, constrained
    from kubernetes_autoscaler_tpu_torch.ops.kernels import pack_kernel

    t0 = time.perf_counter()
    enc, groups = build_world(NODES, PODS, POD_GROUPS, NODEGROUPS,
                              RESIDENTS_PER_NODE, DEVICE, constrained=True)
    log(f"[constrained] world encoded in {time.perf_counter() - t0:.1f} s: "
        f"{describe(enc, groups)}, max_new_nodes {MAX_NEW_NODES}, "
        f"max_pods_per_node {MAX_PODS_PER_NODE} ({card})")
    if not enc.has_constraints:
        raise AssertionError("the constrained world has no constraints")
    kinds = constraint_kinds(enc)
    log(f"[constrained] pending groups by kind: {json.dumps(kinds)}")
    if (kinds["zone spread"], kinds["hostname spread"],
            kinds["hostname anti-affinity to residents"],
            kinds["zone affinity"], kinds["host check"]) != (5, 5, 5, 5, 0):
        raise AssertionError(f"unexpected constraint kinds {kinds}")
    limit_cap = torch.full((groups.ng,), MAX_NEW_NODES, dtype=torch.int32,
                           device=DEVICE)

    def step(on_phase=None):
        return autoscale_step.run_once_fused(
            enc.nodes, enc.specs, enc.scheduled, groups, limit_cap, dims,
            max_new_nodes=MAX_NEW_NODES, max_pods_per_node=MAX_PODS_PER_NODE,
            planes=enc.planes, with_constraints=True, on_phase=on_phase)

    step()                                               # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pack_kernel.pack_groups_batched.launches = 0
    bounds = list(autoscale_step.PHASES) + ["end"]
    step_ms, phase_ms = [], {p: [] for p in autoscale_step.PHASES}
    waves, reads = {p: [] for p in autoscale_step.PHASES}, \
        {p: [] for p in autoscale_step.PHASES}
    for _ in range(CON_STEPS):
        events, counts = {}, {}

        def on_phase(name, events=events, counts=counts):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name] = ev
            counts[name] = wave_counts()

        t0 = time.perf_counter()
        decision, resident = step(on_phase)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for a, b in zip(bounds, bounds[1:]):
            phase_ms[a].append(events[a].elapsed_time(events[b]))
            waves[a].append(counts[b][0] - counts[a][0])
            reads[a].append(counts[b][1] - counts[a][1])
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    k1 = pack_kernel.pack_groups_batched.launches
    log(f"[constrained] step ms over {CON_STEPS} steps: {step_ms}; p50 "
        f"{pct(step_ms, 50)} p90 {pct(step_ms, 90)} ({card})")
    for p in autoscale_step.PHASES:
        log(f"[constrained] phase {p} ms (CUDA events): p50 "
            f"{pct(phase_ms[p], 50)} p90 {pct(phase_ms[p], 90)}; waves a "
            f"step {sorted(set(waves[p]))}, flag reads a step "
            f"{sorted(set(reads[p]))} ({card})")
    log(f"[constrained] peak device memory allocated: {peak_mib:.1f} MiB; "
        f"K1 launches {k1} in {CON_STEPS} steps (the constrained pack "
        f"replaces it) ({card})")
    if k1:
        raise AssertionError("K1 ran on the constrained path")
    # the wave-check interval, in interleaved rounds before the profiler
    # runs: the filter phase (where the waves are) by CUDA events, the step
    # by the host clock, outputs byte-equal at every interval
    want = flat((decision, resident))
    default = constrained.WAVE_CHECK
    sweep = {k: {"step": [], "filter": [], "waves": 0, "reads": 0}
             for k in WAVE_CHECKS}
    try:
        for _ in range(WAVE_ROUNDS):
            for k in WAVE_CHECKS:
                constrained.WAVE_CHECK = k
                events = {}

                def on_phase(name, events=events):
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    events[name] = ev

                w0 = wave_counts()
                t0 = time.perf_counter()
                out = step(on_phase)
                torch.cuda.synchronize()
                row = sweep[k]
                row["step"].append((time.perf_counter() - t0) * 1e3)
                row["filter"].append(events["filter"].elapsed_time(
                    events["scale_up"]))
                w1 = wave_counts()
                row["waves"], row["reads"] = w1[0] - w0[0], w1[1] - w0[1]
                for path, t in flat(out).items():
                    if not torch.equal(t, want[path]):
                        raise AssertionError(f"WAVE_CHECK={k}: {path} differs")
    finally:
        constrained.WAVE_CHECK = default
    for k, row in sweep.items():
        log(f"[constrained] WAVE_CHECK {k}: step ms {row['step']} (median "
            f"{statistics.median(row['step'])}), filter ms {row['filter']} "
            f"(median {statistics.median(row['filter'])}), waves a step "
            f"{row['waves']}, flag reads a step {row['reads']}, outputs "
            f"byte-equal ({card})")

    profile_step(step, pct(step_ms, 50), profile_dir, tag="[constrained]",
                 trace_name="chip_smoke_constrained_step.trace.json")

    d = decision
    if not bool((d.verdict <= enc.specs.count).all()):
        raise AssertionError("verdict exceeds the pending count")
    if not bool((d.alloc_after <= enc.nodes.cap)[enc.nodes.valid].all()):
        raise AssertionError("alloc_after exceeds cap on a valid node")
    if not bool((d.est_scheduled <= d.pending_after[None, :]).all()):
        raise AssertionError("an option schedules more than is pending")
    assert_finite("[constrained]", (decision, resident))
    s = enc.specs
    live = s.count > 0
    for name, mask in (("zone spread", s.spread_kind == 2),
                       ("hostname spread", s.spread_kind == 1),
                       ("zone affinity", s.aff_kind == 2),
                       ("hostname anti-affinity",
                        enc.planes.anti_host_cnt.sum(dim=1) > 0)):
        rows = (mask & live).nonzero().flatten()
        log(f"[constrained] {name}: pending {s.count[rows].tolist()}, "
            f"placed on existing nodes {d.verdict[rows].tolist()}, "
            f"best option schedules "
            f"{d.est_scheduled[:, rows].max(dim=0).values.tolist()}")
    best = int(torch.argmin(torch.where(d.scores.valid, d.scores.waste,
                                        float("inf"))))
    log(f"[constrained] verdict {int(d.verdict.sum())} placed on existing "
        f"nodes, pending after {int(d.pending_after.sum())}, options valid "
        f"{int(d.scores.valid.sum())}, least-waste option {best} "
        f"({int(d.est_node_count[best])} nodes), drainable "
        f"{int(d.drainable.sum())}, blocked {int(d.has_blocker.sum())}")

    cluster = ClusterTensors(nodes=enc.nodes, pending=enc.specs,
                             scheduled=enc.scheduled, groups=groups,
                             planes=enc.planes)
    out = {}

    def once():
        out["once"] = autoscale_step.run_once_sim(
            cluster, dims, max_new_nodes=MAX_NEW_NODES,
            max_pods_per_node=MAX_PODS_PER_NODE, with_constraints=True)

    ms = host_ms(once, CON_PHASED_STEPS, warmup=0)
    up, down = out["once"]
    assert_finite("[constrained] run_once_sim", (up, down))
    log(f"[constrained] run_once_sim with constraints, step ms over "
        f"{CON_PHASED_STEPS} steps: {ms}; fits existing "
        f"{int(up.fits_existing.sum())}, best {int(up.best)}, drainable "
        f"{int(down.removal.drainable.sum())} ({card})")


def constrained_cpu_card_phase(dims, card):
    """Phase 11: the constrained steps on the CPU and on the card on the
    every-kind world (kinds_objects) at 512 nodes."""
    from kubernetes_autoscaler_tpu_torch.ops import autoscale_step

    runs = {}
    for dev in ("cpu", DEVICE):
        e, gr = encode_world(kinds_objects(SMALL_NODES), dev)
        cap = torch.full((gr.ng,), MAX_NEW_NODES, dtype=torch.int32,
                         device=dev)
        w0 = wave_counts()
        fused = autoscale_step.run_once_fused(
            e.nodes, e.specs, e.scheduled, gr, cap, dims,
            max_new_nodes=MAX_NEW_NODES, max_pods_per_node=MAX_PODS_PER_NODE,
            planes=e.planes, with_constraints=True)
        up = autoscale_step.scale_up_sim(
            e.nodes, e.specs, e.scheduled, gr, dims,
            max_new_nodes=MAX_NEW_NODES, planes=e.planes,
            with_constraints=True)
        down = autoscale_step.scale_down_sim(
            e.nodes, e.specs, e.scheduled,
            max_pods_per_node=MAX_PODS_PER_NODE, planes=e.planes,
            max_zones=dims.max_zones, with_constraints=True)
        w1 = wave_counts()
        wave_row = int((e.specs.count == KINDS_WAVE_PODS).nonzero()[0])
        capped = int(fused[0].verdict[wave_row])
        log(f"[constrained-cpu-card] {dev}: kinds "
            f"{json.dumps(constraint_kinds(e))}; waves {w1[0] - w0[0]}, flag "
            f"reads {w1[1] - w0[1]}; the one-zone spread placed {capped} of "
            f"{KINDS_WAVE_PODS}")
        if capped != 128:
            raise AssertionError(f"the one-zone spread placed {capped}, not "
                                 f"the MAX_WAVES cap of 128")
        runs[dev] = {"run_once_fused": fused, "scale_up_sim": up,
                     "scale_down_sim": down}
    for name in runs["cpu"]:
        n_leaves, worst = compare_cpu_card(f"[constrained-cpu-card] {name}",
                                           runs["cpu"][name],
                                           runs[DEVICE][name])
        log(f"[constrained-cpu-card] 512-node {name}: {n_leaves} leaves, "
            f"every int and bool leaf byte-equal CPU vs card; worst float "
            f"relative difference {worst:.3g} ({card})")
    chosen = []
    for dev in ("cpu", DEVICE):
        sc = runs[dev]["run_once_fused"][0].scores
        chosen.append(int(torch.argmin(torch.where(sc.valid, sc.waste,
                                                   float("inf")))))
    if chosen[0] != chosen[1]:
        raise AssertionError(f"least-waste option {chosen} CPU vs card")


def constrained_loop_world(n_nodes, n_pods,
                           residents_per_node=RESIDENTS_PER_NODE):
    """The constrained bench world as a FakeCluster: node groups ng{t} of
    the bench templates, node i in ng{i % 6} (template i % 6 has its pool,
    disk and zone labels), its residents, and `n_pods` pending pods p{seq}
    of group seq % POD_GROUPS. Returns (fake, make_pod) for LoopScript."""
    from kubernetes_autoscaler_tpu_torch.utils.fakecluster import FakeCluster

    nodes, residents, templates = bench_objects(
        n_nodes, 0, POD_GROUPS, NODEGROUPS, residents_per_node,
        constrained=True)
    fake = FakeCluster()
    for t, (tmpl, _, _) in enumerate(templates):
        fake.add_node_group(f"ng{t}", tmpl, min_size=0, max_size=4 * n_nodes)
    for i, nd in enumerate(nodes):
        fake.add_existing_node(f"ng{i % 6}", nd)
    for p in residents:
        fake.add_pod(p)
    make = bench_pod_factory(POD_GROUPS, constrained=True)

    def make_pod(seq, k):
        return make(k % POD_GROUPS, f"p{seq}")

    for i in range(n_pods):
        fake.add_pod(make_pod(i, i))
    return fake, make_pod


def loop_constrained_phase(card):
    """Phase 12: the control loop on the constrained bench world at full
    width with [loop]'s churn: one cold loop, CON_LOOP_STEPS timed."""
    from kubernetes_autoscaler_tpu_torch.core.scaledown import native_confirm
    from kubernetes_autoscaler_tpu_torch.ops.kernels import pack_kernel

    t0 = time.perf_counter()
    fake, make_pod = constrained_loop_world(LOOP_NODES, LOOP_PODS)
    a = loop_autoscaler(fake, DEVICE)
    script = LoopScript(fake, LOOP_NODES, LOOP_PODS, make_pod,
                        "node-{}".format)
    log(f"[loop-constrained] world built in {time.perf_counter() - t0:.1f} "
        f"s: {LOOP_NODES} nodes, {RESIDENTS_PER_NODE * LOOP_NODES} residents, "
        f"{LOOP_PODS} pending pods in {POD_GROUPS} groups, 20 of them "
        f"constrained ({card})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = a.run_once(now=1000.0)
    torch.cuda.synchronize()
    log(f"[loop-constrained] cold loop {time.perf_counter() - t0} s: "
        f"fused_mode {st.fused_mode}, pending {st.pending_pods} ({card})")
    hist = a.metrics.histogram("function_duration_seconds")
    sums0 = {k[0][1]: v for k, v in hist._sums.items()}
    pack_kernel.pack_groups_batched.launches = 0
    ms, rows = [], []
    for loop in range(CON_LOOP_STEPS):
        script.before(loop)
        w0 = wave_counts()
        s0 = dict(hist._sums)
        t0 = time.perf_counter()
        st = a.run_once(now=1010.0 + 10.0 * loop)
        ms.append((time.perf_counter() - t0) * 1e3)
        w1 = wave_counts()
        spans = {k[0][1]: (v - s0.get(k, 0.0)) * 1e3
                 for k, v in hist._sums.items()}
        rows.append({"loop": loop, "ms": ms[-1], "fused_mode": st.fused_mode,
                     "speculation": st.speculation,
                     "round_trips": st.loop_device_round_trips,
                     "encode": f"{a._world_store.last_mode}/"
                               f"{a._world_store.last_cause}",
                     "h2d_bytes": a._world_store.last_h2d_bytes,
                     "waves": w1[0] - w0[0], "reads": w1[1] - w0[1],
                     "spans": {k: spans.get(k, 0.0) for k in (
                         "snapshot_build", "fused_dispatch",
                         "speculative_dispatch")},
                     "scaled_up": bool(st.scale_up is not None
                                       and st.scale_up.scaled_up),
                     "pending": st.pending_pods})
        script.after(loop)
    torch.cuda.synchronize()
    for r in rows:
        log(f"[loop-constrained] loop {r['loop']}: {r['ms']} ms, fused_mode "
            f"{r['fused_mode']}, speculation {r['speculation']}, round trips "
            f"{r['round_trips']}, encode {r['encode']}, world-store h2d "
            f"{r['h2d_bytes']} B, waves {r['waves']}, flag reads {r['reads']} "
            f"(real and speculative dispatch), host ms "
            f"{json.dumps(r['spans'])}, scaled up {r['scaled_up']}, pending "
            f"{r['pending']} ({card})")
    log(f"[loop-constrained] loop ms over {CON_LOOP_STEPS} loops: p50 "
        f"{pct(ms, 50)} p90 {pct(ms, 90)}; K1 launches "
        f"{pack_kernel.pack_groups_batched.launches} ({card})")
    sums = {k[0][1]: v - sums0.get(k[0][1], 0.0)
            for k, v in hist._sums.items()}
    total = sum(ms) / 1e3
    for name in ("snapshot_build", "fused_dispatch", "fused_harvest",
                 "scale_up", "scale_down_update", "scale_down_confirm",
                 "speculative_dispatch", "main"):
        v = sums.get(name, 0.0)
        log(f"[loop-constrained] phase {name} total {v} s over "
            f"{CON_LOOP_STEPS} loops ({100.0 * v / total:.1f} % of the "
            f"loops' time) ({card})")
    if any(r["fused_mode"] != "fused" for r in rows):
        raise AssertionError("a constrained loop ran phased")
    if any(r["round_trips"] > 2 for r in rows):
        raise AssertionError("a constrained loop took more than 2 round trips")
    if not native_confirm.available():
        raise AssertionError("the native confirmation is not available")


def loop_constrained_cpu_card_phase(card):
    """Phase 13: the constrained loop world at 512 nodes with unneeded time
    0 (the planner confirms and deletes nodes under constraints), 8 loops on
    the CPU and 8 on the card: every loop's decision-surface digests, fused
    mode, speculation outcome and round trips equal; the native
    confirmation ran. Two residents a node, as [loop-cpu-card]'s world: with
    eight, every node holds an `app: a3` resident, the anti-affinity groups
    fit nowhere and every loop scales up, which leaves scale-down no loop."""
    from kubernetes_autoscaler_tpu_torch.core.scaledown import native_confirm

    real = native_confirm.confirm
    runs, confirms = {}, {}
    for dev in ("cpu", DEVICE):
        fake, make_pod = constrained_loop_world(
            LOOP_SMALL_NODES, CON_LOOP_SMALL_PODS, residents_per_node=2)
        a = loop_autoscaler(fake, dev, capture_verdicts=True, unneeded_s=0.0)
        script = LoopScript(fake, LOOP_SMALL_NODES, CON_LOOP_SMALL_PODS,
                            make_pod, "node-{}".format)
        times = []

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return real(*args, **kw)
            finally:
                times.append((time.perf_counter() - t0) * 1e3)

        native_confirm.confirm = timed
        try:
            rows, deleted = [], 0
            for loop in range(LOOP_STEPS):
                script.before(loop)
                st = a.run_once(now=1000.0 + 10.0 * loop)
                rows.append(loop_surfaces(a, st))
                deleted += len(st.scale_down_deleted)
                script.after(loop)
        finally:
            native_confirm.confirm = real
        runs[dev], confirms[dev] = rows, times
        log(f"[loop-constrained-cpu-card] {dev}: {deleted} nodes deleted in "
            f"{LOOP_STEPS} loops; native confirmation ran {len(times)} "
            f"times, ms {times}")
        if not times:
            raise AssertionError(f"the native confirmation never ran on {dev}")
        if not deleted:
            raise AssertionError(f"no node was deleted on {dev}")
    for loop, (c, g) in enumerate(zip(runs["cpu"], runs[DEVICE])):
        if c != g:
            raise AssertionError(f"[loop-constrained-cpu-card] loop {loop}: "
                                 f"CPU {c} vs card {g}")
        log(f"[loop-constrained-cpu-card] loop {loop}: digests equal CPU vs "
            f"card, fused_mode {c['fused_mode']}, speculation "
            f"{c['speculation']}, round trips {c['round_trips']} ({card})")


def profile_loop(card, a, script, first, out_dir):
    """The loop's profile under --profile: loops `first` .. `first` + 3 of
    the churn script under cProfile, then one more under torch.profiler."""
    import cProfile
    import io
    import os
    import pstats
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = cProfile.Profile()
    for loop in range(first, first + 4):
        script.before(loop)
        t0 = time.perf_counter()
        prof.enable()
        a.run_once(now=1010.0 + 10.0 * loop)
        prof.disable()
        log(f"[profile] loop {loop} under cProfile: "
            f"{(time.perf_counter() - t0) * 1e3} ms ({card})")
        script.after(loop)
    os.makedirs(out_dir, exist_ok=True)
    prof.dump_stats(os.path.join(out_dir, "loop.pstats"))
    for key, n in (("cumulative", 60), ("tottime", 40)):
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats(key).print_stats(n)
        for line in buf.getvalue().splitlines():
            if line.strip():
                log(f"[profile] loop {key} {line}")
    loop = first + 4
    script.before(loop)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        a.run_once(now=1010.0 + 10.0 * loop)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = defaultdict(lambda: [0, 0.0])
    for ev in tp.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name][0] += 1
            by_name[ev.name][1] += ev.time_range.elapsed_us() / 1e3
    kernels = sum(c for c, _ in by_name.values())
    busy_ms = sum(t for _, t in by_name.values())
    script.after(loop)
    log(f"[profile] one loop under torch.profiler: {wall_ms} ms wall, "
        f"{kernels} device kernels, {busy_ms} ms of kernel time, busy share "
        f"of that loop's wall time {busy_ms / wall_ms} ({card})")
    for name, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        log(f"[profile] loop {t} ms {c:6d}x {name[:110]}")


# ---------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one fused step and the control loop "
                         "(host and device); traces and stats go to DIR")
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
    # the host library of the native scale-down confirmation
    from kubernetes_autoscaler_tpu_torch.core.scaledown import native_confirm

    t0 = time.perf_counter()
    if not native_confirm.available():
        raise AssertionError("the native confirmation did not build")
    log(f"[build] host csrc/host/{native_confirm.SOURCE} with "
        f"{build.host_compiler()} in {time.perf_counter() - t0:.2f} s")

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
    # 8. the control loop at the bench_runonce_e2e world
    loop_launches, loop_per_loop, err = loop_phase(card, dims, k1, k1_plain,
                                                   args.profile)
    k1_err = max(k1_err, err)
    # 9. the control loop, CPU against the card at 512 nodes
    loop_cpu_card_phase(card)
    # 10-13. the constrained tier: the fused step at full width, the steps
    # CPU against the card, the control loop at full width and CPU against
    # the card
    constrained_phase(dims, card, args.profile)
    constrained_cpu_card_phase(dims, card)
    loop_constrained_phase(card)
    loop_constrained_cpu_card_phase(card)

    # 14. result: `ms` is the kernel as launched from Python (CUDA events
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
        "loop_launches": loop_launches,
        "loop_launches_per_loop": loop_per_loop,
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

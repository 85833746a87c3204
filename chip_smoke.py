#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py [--profile DIR]

Phases, in order; any failure exits non-zero and no phase carries on past
its own failure:

  1. device     the card's name and power limit (nvidia-smi); no CUDA → exit 1
  2. build      every CUDA source of the port, built with nvcc in parallel,
                and the native confirmation's host library
  3. kernels    each kernel (K1 pack.cu, K2 wavefront.cu, the VPA scatter
                histogram.cu, the wave placer constrained.cu, the drain sweep
                drain.cu, the predicate plane predicates.cu: every case of
                pred_cases through every public function of ops/predicates.py,
                one launch each) against its plain PyTorch version on the card,
                byte for byte, on seeded cases (the wave placer's "place"
                cases through its place entry, one launch and no host read
                each, and as one pack; place_group_constrained at N=5,120,
                with its times, the plain version's on the card and the
                bound); the scatter's times on a skewed batch
  4. main       `run_once_fused` on the bench world (5,000 nodes, 50,000
                pending pods in 25 groups, 40,000 residents, 20 node groups):
                step and phase times, launches per step (K1 2, the drain
                kernel 1, the predicate plane 3), peak memory, invariants, and
                with --profile device
                time by kernel and the device's busy share; K1 on the inputs
                the path gives it and its times there; the drain kernel on
                the step's own sweep inputs (recorded from one step), both
                modes byte-equal to the plain version, one step with no host
                read in the sweep, its times, the plain version's on the
                card and the bound; [predicates]: the predicate plane on the
                step's own plane calls (recorded from one step) byte-equal to
                its plain version on the card, each shape's device time, as
                launched, the plain version's and the bound, and the step with
                the plane against the step with the plain plane in its place
                (kernels a step by torch.profiler, step p50/p90, alternating)
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
                world-store h2d bytes, K1 and drain kernel launches, the host
                time of the speculative dispatch and how long the device stayed busy
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
 10. whatif     the what-if multiverse, branched from [loop]'s autoscaler
                after its timed loops: a `multiverse_step` of 16 lanes (the
                null lane and 15 of bench.py's variants) at full width, 5
                timed calls after a warm one (ms, ms per lane-step, K1 and
                drain kernel launches, round trips, peak memory), lane 0
                byte-equal to a
                serial `run_once_fused` on the branch world (its phase
                times by CUDA events) and its verdict the live loop's; a
                `rollout_multiverse` of 4 lanes x 8 loops of bursty
                traffic (lane 1 a pending surge that grafts new nodes),
                lane 1 equal to `rollout_fused`, one round trip,
                no build-cache growth over a second variant set; bench.py's
                identity gate (48 nodes, 16 lanes x 32 loops: the null
                lane's trajectory digest equals 32 live loops; fused steps/s
                and the speedup over the phased loop); a 512-node world's
                lane and trajectory digests equal on the CPU and the card.
                No host read of the device inside a multiverse step or a
                rollout (torch.cuda sync debug mode "error" until the fetch)
 11. journal    the loop of 8 with the flight journal and the shadow audit
                on (cold loop, 8 timed): loop times beside [loop]'s, the
                journal's and the audit's time a loop, journal bytes,
                rotations and drops, the audit's checks by surface and
                outcome, round trips and K1 launches a loop; every loop's
                decision digests (scale-up, reasons, drain), fused mode,
                speculation and round trips equal [loop]'s; no divergence,
                the plane audited every loop, no rotation or drop; the
                journal replayed on the card without drift (its time a loop,
                K1 launches); one more loop with the `flip_bit` fault on
                the verdict plane, caught in that loop with its bundle
 12. journal-cpu-card  the loop of 9 journaled: recorded on the card and
                replayed on the CPU, recorded on the CPU and replayed on the
                card, both without drift, each side's backend named
 13. entry      [loop]'s world (and one unfittable pod) as a scenario file:
                `python -m kubernetes_autoscaler_tpu_torch` with the journal
                and the shadow audit, 4 loops, /healthz and /metrics scraped
                while it serves (K1 launches read at its exit); then
                `python -m kubernetes_autoscaler_tpu_torch.replay` (exit 0)
                and `python -m kubernetes_autoscaler_tpu_torch.lineage ...
                why` on the unfittable pod (exit 0): exit codes and times
 14. constrained  `run_once_fused` with the constrained tier on the main
                world with BASELINE.json config #5's constraints (20 of the
                25 pending groups: zone spread, hostname spread, hostname
                anti-affinity and zone affinity to residents): step and
                phase times, waves and flag reads per phase, the predicate
                plane's 7 launches a step and its [predicates] as in 4, one
                step under
                torch.profiler, peak memory, the decision; the wave-check
                interval swept (outputs byte-equal); `run_once_sim` with
                constraints
 15. constrained-cpu-card  a 512-node world with every constraint kind:
                `run_once_fused`, `scale_up_sim` and `scale_down_sim` with
                constraints on the CPU and on the card, leaves equal as in
                7, the same chosen option, a group capped at MAX_WAVES
 16. loop-constrained  the control loop on the constrained main world with
                the churn of 8: a cold loop, 4 timed; fused, at most 2
                round trips, the native confirmation available
 17. loop-constrained-cpu-card  that loop world at 512 nodes with unneeded
                time 0, 8 loops on the CPU and 8 on the card: digests equal
                every loop, nodes deleted, the native confirmation ran
 18. sidecar    the simulation sidecar serving a fleet: 4 large tenants
                ([loop]'s world, written once as one KAD1 payload, plus a
                delta of each tenant's own) and 4 small ones (1,000 nodes,
                10,000 pending pods) on a batched service (4 lanes, a 25 ms
                window) and on a serial one; per tenant a thread, rounds
                released together: 2 warm-up rounds, 5 timed ScaleUpSim and
                2 timed ScaleDownSim rounds (ms per RPC by kind, class and
                tier, sims/s, batches, occupancy, K1 launches a batch, the
                drain kernel's launches over the ScaleDownSim rounds), a
                lone member padded to 4 lanes, a ninth tenant joining the
                large class, a 500-pod churn delta. Asserted: every batched
                response equals the serial service's, no world h2d and no
                build over the steady rounds, one fetch a batch, the churn
                uploads that tenant's dirty sections alone, the ninth
                tenant's recompiles_per_new_tenant 0, the batched sims free
                of host reads, K1 byte-equal to its plain version on a large
                lane's inputs (and its times there); WhatIf (bench.py's
                variant kinds, a 4-loop rollout) equal to the port's
                whatif/ called directly; with grpcio, ScaleUpSim over gRPC
 19. sidecar-cpu-card  4 tenants of 256 nodes (ScaleUpSim, ScaleDownSim
                batched, WhatIf) and a constrained KAUX tenant of 16 nodes
                (the serial tier) on the CPU and on the card, the shadow
                audit on: ids, ints, bools and chosen options equal, floats
                within rtol 1e-5, no audit divergence
 20. vpa        the VPA recommender on the card at the upstream defaults
                (--recommender-interval=1m, --history-length=8d,
                --history-resolution=1h, 24 h half-lives) over 10,000 VPA
                objects of 5 pods x 2 containers (20,000 aggregates): the
                history (192 hourly points an aggregate) through
                PrometheusHistoryProvider -> feed_history, 10 RunOnce steps a
                minute apart (feed of 100,000 samples, 1 % OOM, recommend of
                every VPA; times split into decay, the feed's host loop and
                device scatter, the percentiles with their fetches and the
                host assembly; fetches a step), the updater over 50,000 pods,
                a checkpoint saved and loaded (bytes, times), peak memory.
                Asserted: every VPA recommended, the target monotone in the
                workload's usage (a memory target with OOMs within the OOM
                bump and one bucket of every higher level's), the checkpoint round trip byte-equal, the
                scatter kernel byte-equal to its plain version on the path's
                inputs (and its times there: as launched, every pass, the
                radix passes alone, index_add_), 2 x (1 + steps) scatter
                calls, 6 fetches a step
 21. vpa-cpu-card  the same script on the CPU: the banks byte-equal after
                the history and every step, every recommendation equal, the
                updater's decisions equal, each side's checkpoint loads on
                the other byte-equal
 22. mesh       the device mesh in the shape of __graft_entry__.py
                dryrun_multichip, on a one-rank NCCL group (one card admits
                no NCCL group of two ranks) at [main]'s world: the path,
                counted, is `scale_up_sim` with the mesh (the filter pack
                through pack_groups_sharded, K1 on every rank; the options
                split over the pods axis, K1 on each rank's slice) and the
                control loop with the mesh on its orchestrator (MESH_LOOPS
                loops of the churn script on [loop]'s world, 5,000 nodes).
                Asserted: pack_groups_sharded byte-equal to the
                filter pack, the sharded estimate byte-equal to the
                unsharded one, `scale_up_sim` with the mesh equal to it
                without (ints exact, floats within rtol 1e-5, the same best
                option), K1 launched, the mesh loop phased with every loop
                counted under fused_deferrals_total{cause="mesh-sharded"}
                and its decision digests equal to the loop's without the
                mesh. Times: the sharded pack beside the filter pack (K1,
                B=1) and the sharded estimate beside the unsharded one; the
                group is destroyed at the phase's end. Then two processes of
                this script form a gloo group on the one card (gloo carries
                CUDA tensors through the host) and run the same sharded
                calls on (1, 2) and (2, 1) meshes, each equal to its
                unsharded call, K1 launched on every rank
 23. result     the kernels line, the card line, and the last line
                {"ok": true, "device": {...}}

Imports nothing of JAX and nothing of the JAX package: the worlds are built
and encoded by the port's own object model and encoder.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

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
# K2 launches checked and timed besides the chosen one: (cluster size,
# where each CTA keeps its lanes of the free plane: 1 device memory, 2 shared
# memory)
K2_FORCED = ((8, 1), (16, 1), (8, 2), (16, 2))
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
    """{path: tensor} over a port result tree, {path: array} over a fetched
    one (None and int fields skipped)."""
    import dataclasses

    if tree is None or isinstance(tree, int):
        return {}
    if isinstance(tree, (torch.Tensor, np.ndarray)):
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
    worst float relative difference). [mesh] holds two card trees to it."""
    c_leaves, g_leaves = flat(cpu_tree), flat(card_tree)
    if sorted(c_leaves) != sorted(g_leaves):
        raise AssertionError(f"{name}: the trees differ in structure")
    worst = 0.0
    for path, c in c_leaves.items():
        c, g = c.cpu(), g_leaves[path].cpu()
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


# ---------------------------------------------------------------- K2 checks


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


def k2_forced(n, r, g):
    """The K2_FORCED launches that fit N lanes of R resources: a plane in
    shared memory needs 8R bytes a lane (the plane and the wave's delta)
    for ceil(N / C) lanes a CTA, beside the metadata (here, at most 200,000
    of the H100's 232,448 bytes)."""
    return [(c, p) for c, p in K2_FORCED
            if p == 1 or -(-n // c) * (8 * r + g // 4) <= 200_000]


def check_wave(name, args, kernel, plain):
    """K2 through its wrapper, and launched as each of K2_FORCED that fits,
    against the plain version on `args`; returns the max abs
    difference."""
    from kubernetes_autoscaler_tpu_torch.ops.bitplane import pack_group_bits
    from kubernetes_autoscaler_tpu_torch.ops.kernels import wavefront_kernel

    got = kernel(*args)
    want = plain(*args)
    bits = (args[0], pack_group_bits(args[1]), *args[2:4],
            args[4].to(torch.int32), args[5])
    n, r = args[0].shape
    launches = k2_forced(n, r, args[2].shape[0])
    forced = [wavefront_kernel.launch(*bits, cluster=c, placement=p)
              for c, p in launches]
    torch.cuda.synchronize()
    err = check_equal(name, got, want)
    for (c, p), f in zip(launches, forced):
        err = max(err, check_equal(f"{name} (cluster {c}, placement {p})",
                                   f, want))
    log(f"[kernels] pack_groups_wavefront == plain: {name} "
        f"(G={args[2].shape[0]} N={n} waves {tuple(args[5].shape)}; also "
        f"as (cluster, placement) {launches})")
    return err


def live_waves(a) -> int:
    """Waves of `a` (free, mask, req, count, limit_one, waves) with a live
    slot: a group whose count is negative, or positive with a mask bit."""
    mask, count, waves = a[1], a[3], a[5]
    g = waves.clamp(min=0).long()
    cnt = count[g]
    live = (waves >= 0) & (cnt != 0) & ((cnt < 0) | mask.any(dim=1)[g])
    return int(live.any(dim=1).sum())


def k2_times(a, kernel, plain):
    """K2's times on the wrapper arguments `a` (free, mask, req, count,
    limit_one, waves), as k1_times takes K1's: the kernel's device time,
    as launched from Python, with every mask bit clear (every slot with a
    positive count dead: the dead-slot floor) and with the free plane zero
    (every slot live, scanned, placing nothing: the live-slot depth); the
    device time of each K2_FORCED launch; the wrapper's and the
    plain version's time; the bound; the launch configuration and the
    waves with a live slot."""
    from kubernetes_autoscaler_tpu_torch.ops.bitplane import pack_group_bits
    from kubernetes_autoscaler_tpu_torch.ops.kernels import wavefront_kernel

    bits = (a[0], pack_group_bits(a[1]), *a[2:4], a[4].to(torch.int32), a[5])
    t = {"kernel": cuda_ms(lambda: wavefront_kernel.launch(*bits), REPS,
                           hold=True),
         "launch": cuda_ms(lambda: wavefront_kernel.launch(*bits), REPS)}
    no_fit = (bits[0], torch.zeros_like(bits[1]), *bits[2:])
    t["dead"] = cuda_ms(lambda: wavefront_kernel.launch(*no_fit), REPS,
                        hold=True)
    no_room = (torch.zeros_like(bits[0]), *bits[1:])
    t["live"] = cuda_ms(lambda: wavefront_kernel.launch(*no_room), REPS,
                        hold=True)
    t["forced"] = {(c, p): cuda_ms(lambda c=c, p=p: wavefront_kernel.launch(
        *bits, cluster=c, placement=p), REPS, hold=True)
        for c, p in k2_forced(*a[0].shape, a[2].shape[0])}
    t["wrapper"] = cuda_ms(lambda: kernel(*a), REPS)
    t["plain"] = cuda_ms(lambda: plain(*a), REPS)
    t["bound"], t["bound_by"] = wave_bound(bits, a[1])
    n, r = a[0].shape
    t["config"] = wavefront_kernel.config(a[2].shape[0], n, r, a[5].shape[0])
    t["waves"] = live_waves(a)
    return t


def k2_line(t) -> str:
    from kubernetes_autoscaler_tpu_torch.ops.kernels import wavefront_kernel

    per_wave = t["kernel"] / max(t["waves"], 1)
    forced = ", ".join(
        f"C={c} {wavefront_kernel.PLACEMENTS[p]} {ms} ms"
        for (c, p), ms in t["forced"].items())
    return (f"cluster of {t['config']['cluster']} CTAs x "
            f"{t['config']['threads']} threads ({t['config']['smem']} B "
            f"shared memory each), free plane in {t['config']['plane']}: kernel {t['kernel']} ms (device time; "
            f"{t['launch']} ms as launched from Python), {per_wave} ms per "
            f"wave over {t['waves']} live waves, every mask bit clear "
            f"(dead-slot floor) {t['dead']} ms, free plane zero (live-slot "
            f"depth) {t['live']} ms, forced: {forced}; wrapper with "
            f"checks and mask packing {t['wrapper']} ms, plain {t['plain']} "
            f"ms, bound {t['bound']} ms ({t['bound_by']})")


# ---------------------------------------------------------------- profile


def profile_step(step, step_ms_p50, out_dir, tag="[profile]",
                 trace_name="chip_smoke_step.trace.json"):
    """One step under torch.profiler: device time by kernel name, the number
    of device kernels, and the device's busy share of an unprofiled step
    (summed kernel time over the step's p50). The trace goes to out_dir
    (none without it). Returns (kernels, kernel ms)."""
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


def main_step(enc, groups, dims):
    """(limit_cap, step) of the main world: `step(on_phase=None)` is one
    `run_once_fused` at the main path's options."""
    from kubernetes_autoscaler_tpu_torch.ops import autoscale_step

    limit_cap = torch.full((groups.ng,), MAX_NEW_NODES, dtype=torch.int32,
                           device=DEVICE)

    def step(on_phase=None):
        return autoscale_step.run_once_fused(
            enc.nodes, enc.specs, enc.scheduled, groups, limit_cap, dims,
            max_new_nodes=MAX_NEW_NODES, max_pods_per_node=MAX_PODS_PER_NODE,
            on_phase=on_phase)

    return limit_cap, step


def drain_launches():
    """The drain kernel's launches so far; None for a port without the
    kernel (an older tree measured by tools/torch_loop_ab.py)."""
    try:
        from kubernetes_autoscaler_tpu_torch.ops.kernels import drain_kernel
    except ImportError:
        return None
    return drain_kernel.launch.launches


def main_phase(args, dims, kernel, plain):
    """Phase 4: the fused step on the main world. Returns (world, K1
    launches, K1 entry fields, max abs err, drain kernel launches, row P
    launches) over the timed steps (the drain's and row P's None for a port
    without the kernel)."""
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
    limit_cap, step = main_step(enc, groups, dims)

    for _ in range(2):                                   # warm-up
        step()
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    pack_kernel.pack_groups_batched.launches = 0
    reset_pred_launches()
    d0 = drain_launches()
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
    d_launches = None if d0 is None else drain_launches() - d0
    p_launches = pred_launches()
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
    if d_launches is not None:
        log(f"[main] drain kernel launches: {d_launches} in {STEPS} steps "
            f"({d_launches / STEPS:g} per step)")
        if d_launches != STEPS:
            raise AssertionError(f"expected 1 drain launch per step, got "
                                 f"{d_launches} in {STEPS} steps")
    if p_launches is not None:
        log(f"[main] predicate plane (row P) launches: {p_launches} in {STEPS} "
            f"steps ({p_launches / STEPS:g} per step: the filter, the "
            f"templates, the drain's preparation)")
        if p_launches != 3 * STEPS:
            raise AssertionError(f"expected 3 row P launches per step, got "
                                 f"{p_launches} in {STEPS} steps")
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
    return (enc, groups), launches, entry, max_err, d_launches, p_launches


# ---------------------------------------------------------------- the drain


def check_drain(name, inp, kk) -> int:
    """Byte equality of the drain kernel with its plain version on the card,
    in both modes (the sweep's outputs and the reason pass's); returns the
    max abs difference."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import drain_kernel

    err = 0
    for explain in (False, True):
        got = drain_kernel.sweep(inp, kk, explain)
        want = drain_kernel.sweep_plain(inp, kk, explain)
        torch.cuda.synchronize()
        for k, (g, w) in enumerate(zip(got, want)):
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"{name}: output {k} (explain={explain}) "
                                     f"{g.dtype}{tuple(g.shape)} vs "
                                     f"{w.dtype}{tuple(w.shape)}")
            if g.numel():
                err = max(err, int((g.long() - w.long()).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: output {k} (explain={explain}) "
                                     f"differs from the plain version")
    n, r = inp.free.shape
    log(f"[kernels] drain sweep == plain: {name} (C={inp.candidates.shape[0]} "
        f"N={n} R={r} G={inp.req.shape[0]} P={inp.node_idx.shape[0]} "
        f"MPN={inp.mpn} K={kk}), the sweep and the reason pass")
    return err


def drain_bound(inp, nodes_needed):
    """(bound ms, 'bytes'|'operations') of one sweep (not explaining) on
    these inputs: each input read once and each output written once; the
    operations of the fit on every node the candidates' slots needed
    (`nodes_needed`, the kernel's count for this call): 4R a node (load,
    debit, divide, min a resource) plus 8 (the gates, the caps, the scan).
    """
    c, mpn = inp.candidates.shape[0], inp.mpn
    in_bytes = sum(t.numel() * t.element_size() for t in vars(inp).values())
    out_bytes = 2 * c + 2 * 4 * c + 2 * 4 * c * mpn
    r = inp.free.shape[1]
    t_bytes = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
    t_ops = nodes_needed * (4 * r + 8) / H100_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_drain_topo(name, inp, topo, kk) -> tuple[int, int, int]:
    """Byte equality of the drain kernel's topology mode with the plain
    version on the card, in both modes; the plain version launches no
    kernel (its waves are the plain wave placer's, not the kernels' wave
    body). Returns (max abs difference, the plain version's active lanes
    of the sweep, the kernel's waved lanes)."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import (
        constrained_kernel,
        drain_kernel,
    )

    err = 0
    counter = drain_kernel.wave_counter(DEVICE)
    for explain in (False, True):
        lanes = drain_kernel.sweep_plain.active_lanes
        launches = (constrained_kernel.launch.launches,
                    drain_kernel.launch.launches)
        want = drain_kernel.sweep_plain(inp, kk, explain, topo=topo)
        lanes = drain_kernel.sweep_plain.active_lanes - lanes
        if (constrained_kernel.launch.launches,
                drain_kernel.launch.launches) != launches:
            raise AssertionError(f"{name}: the plain sweep launched a kernel")
        counter.zero_()
        got = drain_kernel.sweep(inp, kk, explain, topo=topo)
        torch.cuda.synchronize()
        waved = int(counter[1])
        for k, (g, w) in enumerate(zip(got, want)):
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"{name}: output {k} (explain={explain}) "
                                     f"{g.dtype}{tuple(g.shape)} vs "
                                     f"{w.dtype}{tuple(w.shape)}")
            if g.numel():
                err = max(err, int((g.long() - w.long()).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: output {k} (explain={explain}) "
                                     f"differs from the plain version")
        if waved != lanes:
            raise AssertionError(f"{name}: the kernel waved {waved} lanes, the "
                                 f"plain version {lanes}")
        if not explain:
            sweep_lanes = lanes
    n, r = inp.free.shape
    log(f"[kernels] drain sweep topology mode == plain: {name} "
        f"(C={inp.candidates.shape[0]} N={n} R={r} G={inp.req.shape[0]} "
        f"MPN={inp.mpn} K={kk} Z={topo.max_zones}), the sweep and the reason "
        f"pass; {sweep_lanes} (candidate, slot) lanes re-placed by waves")
    return err, sweep_lanes, waved


def drain_topo_bound(inp, topo, nodes_needed, lane_waves):
    """(bound ms, 'bytes'|'operations') of one topology-mode sweep on these
    inputs: each input (the sweep's and the topology's) read once, each
    output written once; the first fits' operations as `drain_bound`'s,
    and on every node of every wave a lane ran (`lane_waves`, the kernel's
    count) 4R integer operations a resource and 40 more for the gates,
    caps and scans, as `con_bound` counts a wave."""
    c, mpn = inp.candidates.shape[0], inp.mpn
    n, r = inp.free.shape
    tensors = list(vars(inp).values()) + list(vars(topo).values())
    in_bytes = sum(t.numel() * t.element_size() for t in tensors)
    out_bytes = 2 * c + 2 * 4 * c + 2 * 4 * c * mpn
    ops = nodes_needed * (4 * r + 8) + lane_waves * n * (4 * r + 40)
    t_bytes = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def drain_topo_times(name, inp, topo, kk, card, plain_reps=1):
    """The topology mode's times on these inputs: device time (the stream
    held while the host enqueues), as launched from Python, the plain
    version's on the card; the first fits' nodes, the lane-waves and the
    bound of one sweep."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import drain_kernel

    nodes = drain_kernel.node_counter(DEVICE)
    waves = drain_kernel.wave_counter(DEVICE)
    nodes.zero_()
    waves.zero_()
    drain_kernel.sweep(inp, kk, False, topo=topo)
    torch.cuda.synchronize()
    needed, (lane_waves, waved) = int(nodes), waves.tolist()
    bound, bound_by = drain_topo_bound(inp, topo, needed, lane_waves)

    def kernel():
        return drain_kernel.sweep(inp, kk, False, topo=topo)

    t = {"launch": cuda_ms(kernel, REPS), "kernel": cuda_ms(kernel, REPS,
                                                             hold=True),
         "plain": cuda_ms(lambda: drain_kernel.sweep_plain(inp, kk, False,
                                                           topo=topo),
                          plain_reps, warmup=1),
         "bound": bound, "bound_by": bound_by, "nodes_needed": needed,
         "lane_waves": lane_waves, "waved_lanes": waved}
    n, r = inp.free.shape
    log(f"[kernels] drain sweep topology mode {name} (C={inp.candidates.shape[0]} "
        f"N={n} R={r} G={inp.req.shape[0]} MPN={inp.mpn} K={kk} "
        f"Z={topo.max_zones}; first fits needed {needed} nodes, {waved} lanes "
        f"ran {lane_waves} waves): kernel {t['kernel']} ms device time, "
        f"{t['launch']} ms as launched from Python; plain {t['plain']} ms on "
        f"the card; bound {bound} ms ({bound_by}) ({card})")
    return t


def record_drain_call(step):
    """One step with the drain kernel's wrapper recording its inputs:
    (SweepInputs, K)."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import drain_kernel

    got = []
    real = drain_kernel.sweep

    def sweep(inp, kk, explain, chunk=None, topo=None):
        got.append((inp, kk, explain))
        return real(inp, kk, explain, chunk, topo)

    drain_kernel.sweep = sweep
    try:
        step()
        torch.cuda.synchronize()
    finally:
        drain_kernel.sweep = real
    if len(got) != 1 or got[0][2]:
        raise AssertionError(f"the step made {len(got)} drain sweeps, not one")
    return got[0][:2]


def drain_phase(card, dims, world):
    """Phase 4b: the drain kernel on the main step's own sweep inputs:
    byte-equal to the plain version, one launch a step with no host read in
    the sweep (torch.cuda sync debug mode "error" around
    `drain.simulate_removals`), its device time, as launched from Python,
    the reason pass's, the plain version's on the card and the bound.
    Returns (JSON fields, max abs error)."""
    from kubernetes_autoscaler_tpu_torch.ops import drain
    from kubernetes_autoscaler_tpu_torch.ops.kernels import drain_kernel

    enc, groups = world
    _, step = main_step(enc, groups, dims)
    inp, kk = record_drain_call(step)
    err = check_drain("main-path sweep inputs", inp, kk)

    real = drain.simulate_removals

    def guarded(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    d0 = drain_kernel.launch.launches
    drain.simulate_removals = guarded
    try:
        step()
        torch.cuda.synchronize()
    finally:
        drain.simulate_removals = real
    one = drain_kernel.launch.launches - d0
    if one != 1:
        raise AssertionError(f"a step launched the drain kernel {one} times")
    log(f"[main] one step with the sweep under sync debug mode error: no host "
        f"read, {one} drain launch")

    counter = drain_kernel.node_counter(DEVICE)
    counter.zero_()
    drain_kernel.sweep(inp, kk, False)
    torch.cuda.synchronize()
    needed = int(counter)
    n, r = inp.free.shape
    c = inp.candidates.shape[0]
    bound, bound_by = drain_bound(inp, needed)
    t = {"launch": cuda_ms(lambda: drain_kernel.sweep(inp, kk, False), REPS),
         "kernel": cuda_ms(lambda: drain_kernel.sweep(inp, kk, False), REPS,
                           hold=True),
         "explain": cuda_ms(lambda: drain_kernel.sweep(inp, kk, True), REPS,
                            hold=True),
         "plain": cuda_ms(lambda: drain_kernel.sweep_plain(inp, kk, False), 5,
                          warmup=1)}
    log(f"[kernels] drain sweep main path (C={c} N={n} R={r} "
        f"G={inp.req.shape[0]} MPN={inp.mpn} K={kk}; its slots needed {needed} "
        f"nodes, the reference's scan sweeps {c * kk * n}): kernel "
        f"{t['kernel']} ms device time, {t['launch']} ms as launched from "
        f"Python, reason pass {t['explain']} ms; plain {t['plain']} ms on the "
        f"card; bound {bound} ms ({bound_by}) ({card})")
    entry = {"ms": t["launch"], "device_ms": t["kernel"],
             "explain_device_ms": t["explain"], "plain_ms": t["plain"],
             "bound_ms": bound, "bound_by": bound_by, "nodes_needed": needed}
    return entry, err


# ---------------------------------------------------------------- predicates


PRED_AB_STEPS = 10     # steps a side of [predicates]' kernel/plain step A/B


def pred_launches():
    """Row P's launches so far; None for a port without the kernel (an
    older tree measured by tools/torch_loop_ab.py)."""
    try:
        from kubernetes_autoscaler_tpu_torch.ops.kernels import predicate_kernel
    except ImportError:
        return None
    return predicate_kernel.launch.launches


def reset_pred_launches():
    try:
        from kubernetes_autoscaler_tpu_torch.ops.kernels import predicate_kernel
    except ImportError:
        return
    predicate_kernel.launch.launches = 0


class plain_plane:
    """Inside: `predicate_kernel.plane` runs its plain version on the card
    (the route the card took before row P): a measurement of the parent's
    plane, never the main path."""

    def __enter__(self):
        from kubernetes_autoscaler_tpu_torch.ops.kernels import predicate_kernel

        self.pk, self.real = predicate_kernel, predicate_kernel.plane

        def plane(*a, **kw):
            args = predicate_kernel.bind_args(*a, **kw)
            predicate_kernel.check_inputs(*args)
            return predicate_kernel.plane_plain(*args)

        predicate_kernel.plane = plane
        return self

    def __exit__(self, *exc):
        self.pk.plane = self.real


def check_pred(name, args) -> int:
    """Row P on one call's arguments (nodes, specs, checks, bits,
    group_mask, scheduled) against its plain version on the card (the
    resident term through `resident_group_counts` where `scheduled` is
    given), byte for byte, one call; returns the max abs difference."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import predicate_kernel as pk

    before = pk.launch.launches
    got = pk.plane(*args)
    want = pk.plane_plain(*args)
    torch.cuda.synchronize()
    if pk.launch.launches != before + 1:
        raise AssertionError(f"{name}: {pk.launch.launches - before} row P "
                             f"launches, expected 1")
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: row P differs from the plain version")
    return err


def pred_ops(args) -> tuple[int, int]:
    """(the compares these inputs need, the reference formulation's) of one
    plane: a non-zero selector probe against the L label slots, a non-zero
    port against the NP used ports, a non-zero taint against the 2 Tl
    tolerations of a group that does not tolerate all, 2R for resources
    (a subtraction and a compare a slot) and 2 for the gates, on every
    (g, n); the reference compares every slot with every probe slot, zero
    or not. The resident term: 4 compares a pod (valid, two index
    bounds, the group's flag) and one a pair."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import predicate_kernel as pk

    nodes, specs, checks, bits, mask, scheduled = args
    d, _ = pk.check_inputs(*args)
    g, n = d["G"], d["N"]
    need = ref = 0
    if checks & pk.SELECTOR:
        probes = int((specs.sel_req != 0).sum()) + int((specs.sel_neg != 0).sum())
        need += probes * n * d["L"]
        ref += g * n * (d["S"] * d["A"] + d["Sn"]) * d["L"]
    if checks & pk.TAINTS:
        need += (int((~specs.tolerate_all).sum()) * int((nodes.taint_exact != 0).sum())
                 * 2 * d["Tl"])
        ref += g * n * d["T"] * d["Tl"] * 2
    if checks & pk.PORTS:
        need += int((specs.port_hash != 0).sum()) * n * d["NP"]
        ref += g * n * d["PP"] * d["NP"]
    if checks & pk.RESOURCES:
        need += 2 * d["R"] * g * n
        ref += 2 * d["R"] * g * n
    if checks & pk.GATES:
        need += 2 * g * n
        ref += 2 * g * n
    if scheduled is not None:
        need += 4 * d["P"] + g * n
        ref += 4 * d["P"] + g * n
    return need, ref


def pred_bound(args) -> tuple[float, str, int, int]:
    """(bound ms, 'bytes'|'operations', compares needed, the reference's) of
    one plane on these inputs: each plane the checks read once, the group
    mask and the resident pods' valid, node_idx, group_ref and the groups'
    anti_affinity_self once, the output written once; the compares of
    `pred_ops`."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import predicate_kernel as pk

    nodes, specs, checks, bits, mask, scheduled = args
    d, _ = pk.check_inputs(*args)
    in_bytes = sum(
        getattr(nodes if owner == "nodes" else specs, name).numel()
        * getattr(nodes if owner == "nodes" else specs, name).element_size()
        for i, (owner, name, _, _) in enumerate(pk.FIELDS)
        if any(checks & c and i in idx for c, idx in pk.READS.items()))
    in_bytes += 0 if mask is None else mask.numel()
    if scheduled is not None:
        in_bytes += sum(t.numel() * t.element_size() for t in (
            scheduled.valid, scheduled.node_idx, scheduled.group_ref,
            specs.anti_affinity_self))
    out_bytes = d["G"] * d["N"] * (2 if bits else 1)
    need, ref = pred_ops(args)
    t_bytes = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
    t_ops = need / H100_OPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")) \
        + (need, ref)


def pred_times(name, args, card) -> dict:
    """Row P's times on one call's arguments: device time (the stream held
    while the host enqueues), as launched from Python, the plain version's
    on the card, and the bound."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import predicate_kernel as pk

    bound, bound_by, need, ref = pred_bound(args)
    t = {"launch": cuda_ms(lambda: pk.plane(*args), REPS),
         "kernel": cuda_ms(lambda: pk.plane(*args), REPS, hold=True),
         "plain": cuda_ms(lambda: pk.plane_plain(*args), 5, warmup=1),
         "bound": bound, "bound_by": bound_by, "ops_needed": need,
         "ops_reference": ref}
    d, _ = pk.check_inputs(*args)
    t.update(G=d["G"], N=d["N"], P=None if args[5] is None else d["P"])
    log(f"[predicates] {name} (G={d['G']} N={d['N']} checks={args[2]} "
        f"{'uint16 bits' if args[3] else 'bool'}"
        f"{'' if args[5] is None else ', P=%d residents' % d['P']}): "
        f"kernel {t['kernel']} ms "
        f"device time, {t['launch']} ms as launched from Python; plain "
        f"{t['plain']} ms on the card; bound {bound} ms ({bound_by}; "
        f"{need} compares these inputs need, {ref} in the reference's "
        f"formulation) ({card})")
    return t


def record_pred_calls(step) -> list:
    """One step with row P's wrapper recording its arguments: [(nodes,
    specs, checks, bits, group_mask, scheduled)] in call order."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import predicate_kernel

    got = []
    real = predicate_kernel.plane

    def plane(*a, **kw):
        got.append(predicate_kernel.bind_args(*a, **kw))
        return real(*a, **kw)

    predicate_kernel.plane = plane
    try:
        step()
        torch.cuda.synchronize()
    finally:
        predicate_kernel.plane = real
    return got


def pred_phase(card, tag, step, calls_per_step) -> tuple[dict, int]:
    """[predicates]: row P on the step's own plane calls (recorded from one
    step): each byte-equal to the plain version on the card, the times of
    each distinct shape, and the step with row P against the step with the
    plain plane in its place, in one process: kernels a step (one step
    under torch.profiler each) and step p50/p90 (PRED_AB_STEPS steps each,
    alternating). Returns (JSON fields, max abs error)."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import predicate_kernel as pk

    calls = record_pred_calls(step)
    if len(calls) != calls_per_step:
        raise AssertionError(f"{tag}: {len(calls)} plane calls in a step, "
                             f"expected {calls_per_step}")
    err = 0
    shapes = {}
    for i, args in enumerate(calls):
        d, _ = pk.check_inputs(*args)
        kind = {pk.STATIC: "static", pk.SELECTOR: "selector"}.get(
            args[2], f"checks {args[2]}")
        name = f"{tag} call {i} {kind}"
        err = max(err, check_pred(name, args))
        shapes.setdefault((args[2], args[3], d["G"], d["N"],
                           args[5] is not None), (name, args))
    resident = sum(a[5] is not None for a in calls)
    selector = sum(a[2] == pk.SELECTOR for a in calls)
    if resident != 2:
        raise AssertionError(f"{tag}: {resident} plane calls with the "
                             f"resident term, expected 2 (the filter's and "
                             f"the drain's)")
    log(f"[predicates] {tag}: {len(calls)} plane calls a step ({resident} "
        f"with the resident term), each byte-equal to the plain version on "
        f"the card ({card})")
    times = {key: (name, pred_times(name, args, card))
             for key, (name, args) in shapes.items()}
    del calls, shapes

    ab = {"kernel": [], "plain": []}
    for i in range(PRED_AB_STEPS):
        for mode in (("kernel", "plain") if i % 2 == 0 else ("plain", "kernel")):
            def one(mode=mode):
                if mode == "plain":
                    with plain_plane():
                        step()
                else:
                    step()
            ab[mode] += host_ms(one, 1, warmup=1 if i == 0 else 0)
    k_kernel, busy_kernel = profile_step(step, pct(ab["kernel"], 50), None,
                                         tag=f"[predicates] {tag} row P:")
    with plain_plane():
        k_plain, busy_plain = profile_step(step, pct(ab["plain"], 50), None,
                                           tag=f"[predicates] {tag} plain:")
    log(f"[predicates] {tag} step with row P: p50 {pct(ab['kernel'], 50)} p90 "
        f"{pct(ab['kernel'], 90)} ms, {k_kernel} device kernels a step, "
        f"{busy_kernel} ms of kernel time; with the plain plane (the "
        f"route before row P): p50 {pct(ab['plain'], 50)} p90 "
        f"{pct(ab['plain'], 90)} ms, {k_plain} device kernels a step, "
        f"{busy_plain} ms of kernel time ({PRED_AB_STEPS} steps each, "
        f"alternating) ({card})")
    entry = {"calls_per_step": calls_per_step, "selector_calls": selector,
             "kernels_per_step": k_kernel, "plain_kernels_per_step": k_plain,
             "kernel_ms_per_step": busy_kernel,
             "plain_kernel_ms_per_step": busy_plain,
             "step_p50_ms": pct(ab["kernel"], 50),
             "plain_step_p50_ms": pct(ab["plain"], 50),
             "shapes": {name: {k: t[k] for k in (
                 "launch", "kernel", "plain", "bound", "bound_by",
                 "ops_needed", "G", "N", "P")} for name, t in times.values()}}
    return entry, err


def pred_json(launches, err, main, con) -> dict:
    """Row P's entry of the kernels line: the filter's plane at [main]
    (call 0: ms, device_ms, plain_ms, bound_ms), the templates' (call 1)
    and [constrained]'s selector plane (call 1), kernels a step and step
    p50 with row P and with the plain plane, every shape's times."""
    f = main["shapes"]["[main] call 0 static"]
    t = main["shapes"]["[main] call 1 static"]
    sel = con["shapes"]["[constrained] call 1 selector"]
    entry = {
        "name": "predicate_plane",
        "route": "cuda",
        "source": "kubernetes_autoscaler_tpu_torch/csrc/predicates.cu",
        "replaces": "kubernetes_autoscaler_tpu/ops/predicates.py:270",
        "launches": launches,
        "max_abs_err": err,
        "ms": f["launch"], "device_ms": f["kernel"], "plain_ms": f["plain"],
        "bound_ms": f["bound"], "bound_by": f["bound_by"],
        "library_ms": None,
        "checked": True,
        "templates_ms": t["launch"], "templates_device_ms": t["kernel"],
        "templates_plain_ms": t["plain"], "templates_bound_ms": t["bound"],
        "selector_ms": sel["launch"], "selector_device_ms": sel["kernel"],
        "selector_plain_ms": sel["plain"], "selector_bound_ms": sel["bound"],
        "constrained_launches": con["launches"],
        "shapes": f"[main]'s run_once_fused: {main['calls_per_step']} "
                  f"planes a step (the filter's "
                  f"and the drain's G={f['G']} x N={f['N']} with the "
                  f"resident self-anti-affinity term, P={f['P']} pods, "
                  f"inside the call; the templates' G={t['G']} x "
                  f"NG={t['N']}; ms, device_ms, plain_ms, bound_ms at the "
                  f"filter's, templates_* at the templates'); "
                  f"[constrained]'s: {con['calls_per_step']} a step "
                  f"({con['selector_calls']} of them selector planes; "
                  f"selector_* at G={sel['G']} x N={sel['N']}); XLA's "
                  "fusion of ops/predicates.py, no Pallas kernel; plain_ms: "
                  "the plain version on the card (*_plain_kernels_per_step: "
                  "the step's kernels with it); "
                  "library_ms: no single PyTorch call computes the plane",
    }
    for side, e in (("main", main), ("constrained", con)):
        for k in ("kernels_per_step", "plain_kernels_per_step",
                  "kernel_ms_per_step", "plain_kernel_ms_per_step",
                  "step_p50_ms", "plain_step_p50_ms"):
            entry[f"{side}_{k}"] = e[k]
        entry[f"{side}_shapes"] = e["shapes"]
    return entry


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
    t2 = k2_times(a, k2, wavefront_kernel.pack_groups_wavefront_plain)
    n, r = free.shape
    log(f"[kernels] pack_groups_wavefront filter G={req.shape[0]} N={n} R={r} "
        f"waves {tuple(plan.waves.shape)} (W={plan.n_waves}): {k2_line(t2)}")
    k1_args = [free[None].contiguous(), mask[None].contiguous(), req, count,
               order, limit_one]
    max_err = max(max_err, check_pack("partitioned-world filter inputs",
                                      k1_args, k1,
                                      pack_kernel.pack_groups_batched_plain))
    t = k1_times(k1_args, k1, pack_kernel.pack_groups_batched_plain)
    log(f"[kernels] pack_groups_batched on the same inputs (B=1, "
        f"G={req.shape[0]} serial groups, {t['live_groups']} live): "
        f"{k1_line(t)}; K2 / K1 kernel time {t2['kernel'] / t['kernel']}")
    entry = {"ms": t2["launch"], "device_ms": t2["kernel"],
             "plain_ms": t2["plain"], "bound_ms": t2["bound"],
             "bound_by": t2["bound_by"], "cluster": t2["config"]["cluster"],
             "ctas": t2["config"]["cluster"], "free_plane": t2["config"]["plane"],
             "k1_b1_device_ms": t["kernel"]}
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


def loop_autoscaler(fake, device, capture_verdicts=False, unneeded_s=3600.0,
                    **extra):
    """bench_runonce_e2e's options (LOOP_FLAGS spells them as the command
    line's flags) plus `extra` ones."""
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
            scale_down_unready_time_s=3600.0), **delays, **extra)
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
    the loop's inputs, the timed loops' ms and decision surfaces — read
    after each loop's clock stopped — for [journal] to compare with, the
    autoscaler for [whatif] to branch from)."""
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
    ms, rows, surfaces = [], [], []
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
        d0 = drain_launches()
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
            "drain_launches": None if d0 is None else drain_launches() - d0,
            "spec_busy_ms": busy, "spec_issue_ms": spec_issue_ms,
            "scaled_up": bool(st.scale_up is not None
                              and st.scale_up.scaled_up),
            "pending": st.pending_pods, "unneeded": len(st.unneeded_nodes)})
        surfaces.append(loop_surfaces(a, st))
        script.after(loop)
    torch.cuda.synchronize()
    launches = pack_kernel.pack_groups_batched.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    for r in rows:
        log(f"[loop] loop {r['loop']}: {r['ms']} ms, fused_mode "
            f"{r['fused_mode']}, speculation {r['speculation']}, round trips "
            f"{r['round_trips']}, encode {r['encode']}, world-store h2d "
            f"{r['h2d_bytes']} B, K1 launches {r['k1_launches']}, drain "
            f"kernel launches {r['drain_launches']}, "
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
    return (launches, [r["k1_launches"] for r in rows], err, (ms, surfaces),
            a)


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


# ---------------------------------------------------------------- whatif

WHATIF_LANES = 16        # [whatif] a: the null lane and 15 variants
WHATIF_STEPS = 5         # a: timed multiverse steps after a warm one
WHATIF_ROLL_LANES = 4    # b: the null lane and 3 variants
WHATIF_ROLL_T = 8        # b: loops of each rollout
WHATIF_SEED = 11         # b, d: the bursty workload's seed
WHATIF_GATE_NODES = 48   # c: bench.py's world, min(max(nodes // 4, 16), 48)
WHATIF_GATE_T = 32       # c: bench.py's rollout length (16 lanes)
WHATIF_GATE_LOOPS = 8    # c: timed loops of the phased baseline
WHATIF_SMALL_T = 4       # d: loops of the CPU-vs-card rollout


def whatif_variants(b, n_nodes, knob=1.0):
    """bench.py's what-if variant mix: the null lane, then in turn a price
    scale, a scale-down threshold, a max_new cap and one failed node; a
    second `knob` gives a second set of the same kinds."""
    from kubernetes_autoscaler_tpu_torch.whatif.variants import VariantSpec

    vs = [VariantSpec(name="null")]
    for i in range(b - 1):
        kind = i % 4
        if kind == 0:
            vs.append(VariantSpec(name=f"price{i}",
                                  price_scale=0.5 + 0.25 * i * knob))
        elif kind == 1:
            vs.append(VariantSpec(name=f"thresh{i}",
                                  threshold=min(0.2 + 0.05 * i * knob, 0.95)))
        elif kind == 2:
            vs.append(VariantSpec(name=f"cap{i}", max_new_cap=1 + i))
        else:
            vs.append(VariantSpec(name=f"fail{i}",
                                  fail_nodes=(i % n_nodes,)))
    return vs


def roll_variants(n_nodes, knob=1.0):
    """[whatif] b and d: the null lane, a pending surge (so that the
    rollout grafts new nodes where the world has free slots), then
    bench.py's first two kinds."""
    from kubernetes_autoscaler_tpu_torch.whatif.variants import VariantSpec

    return ([VariantSpec(name="surge", pending_scale=2.0 + knob)]
            + whatif_variants(WHATIF_ROLL_LANES - 1, n_nodes, knob)[1:])


def whatif_kw(branch) -> dict:
    st = branch.statics
    return dict(dims=st["dims"], max_new_nodes=st["max_new_nodes"],
                max_pods_per_node=st["max_pods_per_node"])


def compare_host(name, want, got, rtol=None) -> int:
    """Every leaf of the same dtype and shape; int and bool leaves byte-equal,
    float leaves too unless `rtol` is given. Returns the leaves compared."""
    w, g = flat(want), flat(got)
    if sorted(w) != sorted(g):
        raise AssertionError(f"{name}: the trees differ in structure")
    for path, a in w.items():
        b = g[path]
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{name}{path}: {a.dtype}{a.shape} vs "
                                 f"{b.dtype}{b.shape}")
        if a.dtype.kind == "f" and rtol is not None:
            if not np.allclose(b, a, rtol=rtol, atol=0.0):
                raise AssertionError(f"{name}{path}: float leaf differs")
        elif a.tobytes() != b.tobytes():
            raise AssertionError(f"{name}{path}: bytes differ")
    return len(w)


class no_host_reads:
    """Inside: any operation that makes the host wait on the card raises
    (torch.cuda sync debug mode "error"), except the result fetch of
    `ops/hostfetch.fetch_pytree`, which is the one round trip allowed."""

    def __enter__(self):
        from kubernetes_autoscaler_tpu_torch.ops import hostfetch

        self.hostfetch = hostfetch
        self.real = real = hostfetch.fetch_pytree

        def fetch(tree, phases=None):
            torch.cuda.set_sync_debug_mode(0)
            try:
                return real(tree, phases)
            finally:
                torch.cuda.set_sync_debug_mode("error")

        hostfetch.fetch_pytree = fetch
        torch.cuda.set_sync_debug_mode("error")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self.hostfetch.fetch_pytree = self.real
        return False


def whatif_phase(card, loop_a):
    """Phase 10: the multiverse on the card. Returns K1's launches in a
    timed multiverse step and in the timed rollout."""
    from kubernetes_autoscaler_tpu_torch.ops import hostfetch
    from kubernetes_autoscaler_tpu_torch.ops.autoscale_step import (
        PHASES,
        run_once_fused,
    )
    from kubernetes_autoscaler_tpu_torch.ops.kernels import build, pack_kernel
    from kubernetes_autoscaler_tpu_torch.whatif import kernel, report, variants

    k1 = pack_kernel.pack_groups_batched
    t_phase = time.perf_counter()

    # a. multiverse_step at full width, branched from the live loop
    branch = variants.branch_from_live(loop_a)
    live = loop_a._fused_ctx["decision"]
    kw = whatif_kw(branch)
    t0 = time.perf_counter()
    lanes = variants.build_lanes(
        branch, whatif_variants(WHATIF_LANES, LOOP_NODES)[1:],
        pad_to=WHATIF_LANES)
    torch.cuda.synchronize()
    log(f"[whatif] a: branched [loop]'s last fused dispatch (nodes "
        f"{branch.nodes.n}, pending groups {branch.specs.g}, residents "
        f"{branch.scheduled.p}, node groups {branch.groups.ng}); "
        f"{len(lanes.variants)} lanes built in "
        f"{(time.perf_counter() - t0) * 1e3} ms ({card})")
    cap_dev = torch.from_numpy(branch.limit_cap).to(DEVICE)

    def serial():
        dec, _res = run_once_fused(branch.nodes, branch.specs,
                                   branch.scheduled, branch.groups, cap_dev,
                                   **kw)
        return dec

    serial_ms = host_ms(serial, 3, warmup=1)
    events = {}

    def on_phase(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    torch.cuda.synchronize()
    dec_dev, _res = run_once_fused(branch.nodes, branch.specs,
                                   branch.scheduled, branch.groups, cap_dev,
                                   on_phase=on_phase, **kw)
    want = hostfetch.fetch_pytree(dec_dev)
    phase_ms = {p: events[p].elapsed_time(events[q]) for p, q in
                zip(PHASES, PHASES[1:] + ("end",))}
    log(f"[whatif] a: serial run_once_fused on the branch world: p50 "
        f"{pct(serial_ms, 50)} ms over {len(serial_ms)}; phases "
        f"{json.dumps(phase_ms)} ms ({card})")

    torch.cuda.reset_peak_memory_stats()
    with no_host_reads():
        kernel.multiverse_step(lanes.nodes, lanes.specs, lanes.scheduled,
                               lanes.groups, lanes.limit_cap, **kw)
    step_ms, trips, launches, d_launches = [], [], [], []
    for _ in range(WHATIF_STEPS):
        torch.cuda.synchronize()
        hostfetch.reset_round_trips()
        k1.launches = 0
        d0 = drain_launches()
        t0 = time.perf_counter()
        with no_host_reads():
            dec, summary = kernel.multiverse_step(
                lanes.nodes, lanes.specs, lanes.scheduled, lanes.groups,
                lanes.limit_cap, **kw)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(k1.launches)
        d_launches.append(drain_launches() - d0)
        trips.append(hostfetch.round_trips())
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    n_leaves = compare_host("[whatif] a: lane 0 against the serial step",
                            want, kernel._lane(dec, 0))
    if dec.verdict[0].tobytes() != np.asarray(live.verdict).tobytes():
        raise AssertionError("[whatif] a: lane 0's verdict is not the live "
                             "loop's fused decision")
    for path, x in flat(summary).items():
        if x.dtype.kind == "f" and not np.isfinite(x).all():
            raise AssertionError(f"[whatif] a: summary{path} is not finite")
    if any(t != 1 for t in trips):
        raise AssertionError(f"[whatif] a: round trips {trips}, not 1")
    if any(n != 2 * WHATIF_LANES for n in launches):
        raise AssertionError(f"[whatif] a: K1 launches {launches}, not "
                             f"{2 * WHATIF_LANES} a step")
    p50 = pct(step_ms, 50)
    log(f"[whatif] a: multiverse_step B={WHATIF_LANES} ms over "
        f"{WHATIF_STEPS} calls (host clock to the end of the one fetch): "
        f"{step_ms}; p50 {p50} p90 {pct(step_ms, 90)}; ms per lane-step "
        f"{p50 / WHATIF_LANES}; K1 launches a step {launches}, drain kernel "
        f"launches a step {d_launches}; round trips {trips}; peak device "
        f"memory {peak_mib:.1f} MiB ({card})")
    log(f"[whatif] a: lane 0 == serial run_once_fused ({n_leaves} leaves "
        f"byte-equal), verdict == the live loop's; lanes' best "
        f"{summary.best.tolist()}, nodes added "
        f"{summary.nodes_added.tolist()}, scale-up cost "
        f"{summary.scaleup_cost.tolist()}, disruption "
        f"{summary.disruption.tolist()} ({card})")
    log(f"[whatif] a: lane digests "
        f"{[d[:12] for d in report.lane_digests(dec, lanes.real)]} ({card})")
    del lanes, dec, summary

    # b. rollout_multiverse at full width: bursty traffic, 4 lanes x 8 loops
    from kubernetes_autoscaler_tpu_torch.whatif.generator import (
        WorkloadSpec,
        generate_workload,
        lane_workloads,
    )

    def roll_lanes(knob):
        return variants.build_lanes(branch, roll_variants(LOOP_NODES, knob),
                                    pad_to=WHATIF_ROLL_LANES)

    def workload(ln, kind, t_steps):
        adds, fails = generate_workload(
            WorkloadSpec(kind=kind, seed=WHATIF_SEED), t_steps,
            ln.specs.count.shape[1], ln.nodes.valid.shape[1])
        adds_b, fails_b = lane_workloads(ln.variants, adds, fails)
        return (torch.from_numpy(adds_b).to(ln.nodes.cap.device),
                torch.from_numpy(fails_b).to(ln.nodes.cap.device))

    def roll(ln, adds, fails, kw):
        with no_host_reads():
            return kernel.rollout_multiverse(
                ln.nodes, ln.specs, ln.scheduled, ln.groups, ln.limit_cap,
                ln.thresholds, adds, fails, **kw)

    rl = roll_lanes(1.0)
    adds, fails = workload(rl, "bursty", WHATIF_ROLL_T)
    torch.cuda.synchronize()
    size0 = build.cache_size()
    hostfetch.reset_round_trips()
    k1.launches = 0
    d0 = drain_launches()
    t0 = time.perf_counter()
    traj = roll(rl, adds, fails, kw)
    roll_ms = (time.perf_counter() - t0) * 1e3
    roll_launches, roll_trips = k1.launches, hostfetch.round_trips()
    roll_drain = drain_launches() - d0
    with no_host_reads():
        one = kernel.rollout_fused(
            kernel._lane(rl.nodes, 1), kernel._lane(rl.specs, 1),
            kernel._lane(rl.scheduled, 1), kernel._lane(rl.groups, 1),
            rl.limit_cap[1], rl.thresholds[1], adds[1], fails[1], **kw)
    compare_host("[whatif] b: lane 1 against rollout_fused",
                 kernel._lane(traj, 1), one, rtol=1e-5)
    rl2 = roll_lanes(1.3)
    torch.cuda.synchronize()
    hostfetch.reset_round_trips()
    t0 = time.perf_counter()
    traj2 = roll(rl2, adds, fails, kw)
    roll2_ms = (time.perf_counter() - t0) * 1e3
    roll2_trips = hostfetch.round_trips()
    growth = build.cache_size() - size0
    lane_steps = WHATIF_ROLL_LANES * WHATIF_ROLL_T
    if roll_trips != 1 or roll2_trips != 1:
        raise AssertionError(f"[whatif] b: round trips {roll_trips}, "
                             f"{roll2_trips}, not 1 a rollout")
    if roll_launches != 2 * lane_steps:
        raise AssertionError(f"[whatif] b: K1 launches {roll_launches}, not "
                             f"{2 * lane_steps}")
    if growth != 0:
        raise AssertionError(f"[whatif] b: the build cache grew by {growth}")
    rep = report.build_report(rl, traj=traj)["rollout"]
    rep2 = report.build_report(rl2, traj=traj2)["rollout"]
    log(f"[whatif] b: rollout_multiverse B={WHATIF_ROLL_LANES} "
        f"T={WHATIF_ROLL_T} bursty: {roll_ms} ms ({roll_ms / lane_steps} "
        f"ms per lane-step), second variant set {roll2_ms} ms; K1 launches "
        f"{roll_launches}, drain kernel launches {roll_drain}; round trips "
        f"{roll_trips}, {roll2_trips}; build "
        f"cache growth {growth}; lane 1 == rollout_fused ({card})")
    log(f"[whatif] b: per lane {json.dumps(rep['perLane'])}; trajectory "
        f"digests {[d[:12] for d in rep['trajectoryDigests']]}, second set "
        f"{[d[:12] for d in rep2['trajectoryDigests']]} ({card})")
    del rl, rl2, traj, traj2, one, branch, cap_dev

    # c. bench.py's identity gate: 48 nodes in equilibrium, 16 x 32
    from kubernetes_autoscaler_tpu_torch.whatif.synthetic import (
        synthetic_autoscaler,
        synthetic_branch,
    )

    gate, auto = synthetic_branch(n_nodes=WHATIF_GATE_NODES, n_pending=12,
                                  seed=7, loops=2, pending_milli=64000,
                                  device=DEVICE)
    verd, pend = [], []
    t0 = time.perf_counter()
    for k in range(WHATIF_GATE_T):
        st = auto.run_once(now=2000.0 + 10.0 * k)
        if st.fused_mode != "fused":
            raise AssertionError(f"[whatif] c: live loop {k} ran "
                                 f"{st.fused_mode}")
        verd.append(np.array(auto._fused_ctx["decision"].verdict))
        pend.append(np.array(auto._fused_ctx["decision"].pending_after))
    live_s = time.perf_counter() - t0
    live_digest = report._digest(np.stack(verd), np.stack(pend))
    gkw = whatif_kw(gate)
    gl = variants.build_lanes(
        gate, whatif_variants(WHATIF_LANES, WHATIF_GATE_NODES)[1:],
        pad_to=WHATIF_LANES)
    gl2 = variants.build_lanes(
        gate, whatif_variants(WHATIF_LANES, WHATIF_GATE_NODES, 1.3)[1:],
        pad_to=WHATIF_LANES)
    gadds, gfails = workload(gl, "quiet", WHATIF_GATE_T)
    # bench.py's three timed rollouts (its warm one is a compile, which
    # the port does not have)
    gate_s = []
    for ln in (gl, gl2, gl):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gtraj = roll(ln, gadds, gfails, gkw)
        gate_s.append(time.perf_counter() - t0)
    null_digest = report.trajectory_digests(gtraj, 1)[0]
    if null_digest != live_digest:
        raise AssertionError("[whatif] c: the null lane's trajectory is not "
                             f"{WHATIF_GATE_T} live loops'")
    _fake, phased = synthetic_autoscaler(
        n_nodes=WHATIF_GATE_NODES, n_pending=12, seed=7,
        pending_milli=64000, fused_loop=False, device=DEVICE)
    for k in range(2):
        phased.run_once(now=1000.0 + 10.0 * k)
    phased_s = []
    for k in range(WHATIF_GATE_LOOPS):
        t0 = time.perf_counter()
        phased.run_once(now=2000.0 + 10.0 * k)
        phased_s.append(time.perf_counter() - t0)
    rollout_s = statistics.median(gate_s)
    fused_sps = WHATIF_LANES * WHATIF_GATE_T / rollout_s
    serial_sps = 1.0 / statistics.median(phased_s)
    log(f"[whatif] c: bench.py's gate ({WHATIF_GATE_NODES} nodes, "
        f"{WHATIF_LANES} lanes x {WHATIF_GATE_T} loops): null lane == "
        f"{WHATIF_GATE_T} live loops ({live_s} s); rollouts {gate_s} s, "
        f"median {rollout_s} s; fused steps/s {fused_sps}; phased loop p50 "
        f"{statistics.median(phased_s) * 1e3} ms, serial steps/s "
        f"{serial_sps}; speedup {fused_sps / serial_sps} ({card})")
    del gate, auto, gl, gl2, gtraj, phased

    # d. CPU against the card on a 512-node world
    pods = LOOP_PODS * LOOP_SMALL_NODES // LOOP_NODES
    runs = {}
    for dev in ("cpu", DEVICE):
        fake = loop_world(LOOP_SMALL_NODES, pods)
        a = loop_autoscaler(fake, dev)
        a.run_once(now=1000.0)
        br = variants.branch_from_live(a)
        ln = variants.build_lanes(br, roll_variants(LOOP_SMALL_NODES),
                                  pad_to=WHATIF_ROLL_LANES)
        dkw = whatif_kw(br)
        dec, summary = kernel.multiverse_step(
            ln.nodes, ln.specs, ln.scheduled, ln.groups, ln.limit_cap, **dkw)
        adds, fails = workload(ln, "bursty", WHATIF_SMALL_T)
        traj = kernel.rollout_multiverse(
            ln.nodes, ln.specs, ln.scheduled, ln.groups, ln.limit_cap,
            ln.thresholds, adds, fails, **dkw)
        runs[dev] = (report.lane_digests(dec, ln.real),
                     report.trajectory_digests(traj, ln.real), summary, traj)
    c, g = runs["cpu"], runs[DEVICE]
    if c[0] != g[0] or c[1] != g[1]:
        raise AssertionError("[whatif] d: lane or trajectory digests differ "
                             "between the CPU and the card")
    n_sum = compare_host("[whatif] d: summary", c[2], g[2], rtol=1e-5)
    n_traj = compare_host("[whatif] d: trajectory", c[3], g[3], rtol=1e-5)
    log(f"[whatif] d: {LOOP_SMALL_NODES} nodes, B={WHATIF_ROLL_LANES}, "
        f"T={WHATIF_SMALL_T}: lane digests {[d[:12] for d in c[0]]} and "
        f"trajectory digests {[d[:12] for d in c[1]]} equal on the CPU and "
        f"the card; {n_sum} summary and {n_traj} trajectory leaves within "
        f"rtol 1e-5 ({card})")
    log(f"[whatif] phase wall time {time.perf_counter() - t_phase} s ({card})")
    return {"multiverse_step": launches[-1], "rollout_multiverse":
            roll_launches}


# ---------------------------------------------------------------- journal

# the journal's size bound in the journal phases: its first record is the
# whole world (≈ 40 MB at full width), which the default 64 MB bound (16 MB a
# file) would rotate out, and replay could not rebuild loop 0 without it
JOURNAL_MAX_MB = 1024
# bench_runonce_e2e's options as the process entry's flags (loop_autoscaler)
LOOP_FLAGS = ["--node-shape-bucket", "256", "--group-shape-bucket", "64",
              "--max-new-nodes-static", "256", "--max-pods-per-node", "16",
              "--drain-chunk", "256", "--scale-down-unneeded-time", "1h",
              "--scale-down-unready-time", "1h"]
ENTRY_ITERATIONS = 4


def repo_dir(prefix: str) -> str:
    """A fresh directory in the checkout, named so that .gitignore lists it
    (`journal_*/`): the journals, bundles and scenarios the phases write."""
    return tempfile.mkdtemp(prefix=prefix,
                            dir=os.path.dirname(os.path.abspath(__file__)))


def journal_phase(card, loop_ref):
    """Phase 10: the [loop] world and script on the card with the flight
    journal and the shadow audit on; the journal replayed on the card; the
    flip_bit fault on the verdict plane caught within its loop."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import pack_kernel
    from kubernetes_autoscaler_tpu_torch.replay.harness import replay_journal
    from kubernetes_autoscaler_tpu_torch.sidecar import faults

    k1 = pack_kernel.pack_groups_batched
    tmp = repo_dir("journal_")
    try:
        jdir, adir = os.path.join(tmp, "journal"), os.path.join(tmp, "audit")
        fake = loop_world(LOOP_NODES, LOOP_PODS)
        a = loop_autoscaler(fake, DEVICE, journal_dir=jdir,
                            journal_max_mb=JOURNAL_MAX_MB, shadow_audit=True,
                            shadow_audit_dir=adir)
        script = LoopScript(fake, LOOP_NODES, LOOP_PODS)
        jw, aud = a.journal, a.shadow_auditor
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = a.run_once(now=1000.0)
        torch.cuda.synchronize()
        log(f"[journal] cold loop {time.perf_counter() - t0} s, journal "
            f"{jw.overhead_ns / 1e6} ms of it, first record "
            f"{jw.bytes} B, audit {aud.overhead_ns / 1e6} ms ({card})")
        ms, rows = [], []
        k1.launches = 0
        for loop in range(LOOP_STEPS):
            script.before(loop)
            j0, u0, k0 = jw.overhead_ns, aud.overhead_ns, k1.launches
            t0 = time.perf_counter()
            st = a.run_once(now=1010.0 + 10.0 * loop)
            ms.append((time.perf_counter() - t0) * 1e3)
            rows.append({"journal_ms": (jw.overhead_ns - j0) / 1e6,
                         "audit_ms": (aud.overhead_ns - u0) / 1e6,
                         "k1": k1.launches - k0,
                         "surfaces": loop_surfaces(a, st),
                         "divergent": st.audit_divergence})
            script.after(loop)
        torch.cuda.synchronize()
        launches = k1.launches
        ref_ms, ref_surfaces = loop_ref
        for loop, (r, ref) in enumerate(zip(rows, ref_surfaces)):
            got = r["surfaces"]
            log(f"[journal] loop {loop}: {ms[loop]} ms ([loop] "
                f"{ref_ms[loop]} ms), journal {r['journal_ms']} ms, audit "
                f"{r['audit_ms']} ms, round trips {got['round_trips']}, K1 "
                f"launches {r['k1']}, speculation {got['speculation']} "
                f"({card})")
            # the decision surfaces: [loop] runs without the verdict plane
            for key in ("scaleUp", "reasons", "drain"):
                if got["digests"][key] != ref["digests"][key]:
                    raise AssertionError(f"[journal] loop {loop}: {key} "
                                         f"digest differs from [loop]'s")
            for key in ("fused_mode", "speculation", "round_trips"):
                if got[key] != ref[key]:
                    raise AssertionError(f"[journal] loop {loop}: {key} "
                                         f"{got[key]} vs [loop] {ref[key]}")
        stats = jw.stats()
        log(f"[journal] loop ms over {LOOP_STEPS} loops: p50 {pct(ms, 50)} "
            f"p90 {pct(ms, 90)}; [loop] p50 {pct(ref_ms, 50)} p90 "
            f"{pct(ref_ms, 90)} ({card})")
        journal_ms = statistics.mean(r["journal_ms"] for r in rows)
        log(f"[journal] journal: {journal_ms} ms a loop (overhead_ns), "
            f"{stats['records']} records, "
            f"{stats['bytes']} B, {stats['rotations']} rotations, dropped "
            f"{stats['drops']}, snapshot fallbacks "
            f"{stats['snapshotFallbacks']} ({card})")
        log(f"[journal] audit: {statistics.mean(r['audit_ms'] for r in rows)}"
            f" ms a loop, warm-up {aud.warmup_ms} ms, checks "
            f"{json.dumps(aud.checks)}, divergences {aud.divergences} "
            f"({card})")
        log(f"[journal] K1 launches {launches} in {LOOP_STEPS} loops; the "
            f"decision digests (scale-up, reasons, drain), fused mode, "
            f"speculation and round trips equal [loop]'s every loop ({card})")
        if aud.divergences or any(r["divergent"] for r in rows):
            raise AssertionError("the audit diverged on healthy loops")
        if aud.checks["plane"]["ok"] != LOOP_STEPS + 1:
            raise AssertionError("the plane surface was not audited every "
                                 "loop")
        if stats["rotations"] or stats["drops"]:
            raise AssertionError("the journal rotated or dropped records")
        if launches == 0:
            raise AssertionError("the journaled loops launched K1 no time")

        # the journal replayed on the card
        k1.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = replay_journal(jdir, device=DEVICE)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        replay_launches = k1.launches
        # the cursor-seeding contract: the replayed audit draws from the
        # recorder's seeds (which cells it then audits rides its own,
        # timing-based budget)
        seeds = [[r["seed"] for r in log_[:rep["loops"]]]
                 for log_ in (rep["audit"]["samples"], aud.sample_log)]
        log(f"[journal] replay on the card: {rep['loops']} loops in "
            f"{replay_s} s ({replay_s * 1e3 / rep['loops']} ms a loop, the "
            f"snapshot's rebuild and the cold loop included), zeroDrift "
            f"{rep['zeroDrift']}, K1 launches {replay_launches}, backend "
            f"recorded {rep['backend']['recorded']['platform']} replayed "
            f"{rep['backend']['replayed']['platform']}, audit seeds equal "
            f"the recorder's {seeds[0] == seeds[1]} ({card})")
        if not rep["zeroDrift"]:
            raise AssertionError(f"[journal] the replay drifted: loops "
                                 f"{rep['driftLoops']}")
        if seeds[0] != seeds[1] or len(seeds[0]) != rep["loops"]:
            raise AssertionError("[journal] the replayed audit's seeds differ "
                                 "from the recorder's")
        if replay_launches == 0:
            raise AssertionError("the replay launched K1 no time")

        # one loop with a bit of the fetched verdict plane flipped
        faults.install([{"hook": "verdict_plane", "kind": "flip_bit",
                         "times": 1}], seed=7)
        try:
            script.before(LOOP_STEPS)
            st = a.run_once(now=1010.0 + 10.0 * LOOP_STEPS)
        finally:
            faults.clear()
        with open(st.audit_bundle_path) as f:
            bundle = json.load(f)
        div = bundle["divergences"][0]
        log(f"[journal] flip_bit on the verdict plane: caught in its loop "
            f"{st.audit_divergence}, bundle "
            f"{os.path.basename(st.audit_bundle_path)} ({div['surface']} row {div.get('row')}, xorBits "
            f"{div.get('xorBits')}, backend {bundle['backend']['platform']}),"
            f" supervisor {a.supervisor.state} ({card})")
        if not (st.audit_divergence and div["surface"] == "plane"
                and bundle["journalCursor"][0] == LOOP_STEPS + 1):
            raise AssertionError("the audit missed the flipped bit")
        return {"loop_launches": launches, "replay_launches": replay_launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def journal_cpu_card_phase(card):
    """Phase 11: [loop-cpu-card]'s world and script, journaled: recorded on
    the card and replayed on the CPU, then recorded on the CPU and replayed
    on the card; both replays without drift, each side's backend named."""
    from kubernetes_autoscaler_tpu_torch.replay.harness import replay_journal

    pods = LOOP_PODS * LOOP_SMALL_NODES // LOOP_NODES
    platform = {"cpu": ("cpu", "plain"), DEVICE: ("gpu", "kernel")}
    tmp = repo_dir("journal_")
    try:
        for rec_dev, rep_dev in ((DEVICE, "cpu"), ("cpu", DEVICE)):
            jdir = os.path.join(tmp, f"{rec_dev}-{rep_dev}")
            fake = loop_world(LOOP_SMALL_NODES, pods)
            a = loop_autoscaler(fake, rec_dev, journal_dir=jdir,
                                journal_max_mb=JOURNAL_MAX_MB)
            script = LoopScript(fake, LOOP_SMALL_NODES, pods)
            for loop in range(LOOP_STEPS):
                script.before(loop)
                a.run_once(now=1000.0 + 10.0 * loop)
                script.after(loop)
            t0 = time.perf_counter()
            rep = replay_journal(jdir, device=rep_dev)
            replay_s = time.perf_counter() - t0
            sides = {k: (b["platform"], b["pack"])
                     for k, b in rep["backend"].items()}
            log(f"[journal-cpu-card] recorded on {rec_dev}, replayed on "
                f"{rep_dev}: {rep['loops']} loops in {replay_s} s, zeroDrift "
                f"{rep['zeroDrift']}, backend {json.dumps(sides)} ({card})")
            if not rep["zeroDrift"]:
                raise AssertionError(f"[journal-cpu-card] {rec_dev} to "
                                     f"{rep_dev} drifted: loops "
                                     f"{rep['driftLoops']}")
            if sides != {"recorded": platform[rec_dev],
                         "replayed": platform[rep_dev]}:
                raise AssertionError(f"[journal-cpu-card] backend blocks "
                                     f"{sides}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# run as `python -m` runs a module (runpy, as `__main__`), printing K1's
# launch count at exit: the entry's loops run in this process only
ENTRY_SHIM = (
    "import runpy, sys\n"
    "try:\n"
    "    runpy.run_module('kubernetes_autoscaler_tpu_torch', "
    "run_name='__main__', alter_sys=True)\n"
    "finally:\n"
    "    k1 = sys.modules.get('kubernetes_autoscaler_tpu_torch.ops.kernels."
    "pack_kernel')\n"
    "    print('K1 launches', k1.pack_groups_batched.launches if k1 else 0,"
    " file=sys.stderr, flush=True)\n")


def scenario_doc(fake) -> dict:
    """A FakeCluster as the process entry's scenario JSON (__main__.py):
    the node groups, the nodes, every pod, bound ones with `node_name`."""
    groups = []
    for g in fake.provider.node_groups():
        t = g.template_node_info()
        groups.append({"id": g.id(), "min": g.min_size(),
                       "max": g.max_size(),
                       "template": {"name": t.name, **node_spec(t)}})
    nodes = [{"group": fake.provider.node_group_for_node(nd).id(),
              "name": nd.name, **node_spec(nd)} for nd in fake.list_nodes()]
    pods = [{"name": p.name, "cpu_milli": round(p.requests["cpu"] * 1000),
             "mem_mib": int(p.requests["memory"]) // 2 ** 20,
             "owner_name": p.owner.name, "node_name": p.node_name}
            for p in fake.list_pods()]
    return {"node_groups": groups, "nodes": nodes, "pods": pods}


def node_spec(nd) -> dict:
    return {"cpu_milli": round(nd.allocatable["cpu"] * 1000),
            "mem_mib": int(nd.allocatable["memory"]) // 2 ** 20,
            "pods": int(nd.allocatable["pods"])}


def entry_phase(card):
    """Phase 12: the command lines on the card. [loop]'s world (plus one pod
    no node or template holds, so that `why` has a refused pod to explain)
    as a scenario; `python -m kubernetes_autoscaler_tpu_torch` journals
    ENTRY_ITERATIONS loops with the shadow audit on while /healthz and
    /metrics are scraped; then the replay and lineage command lines."""
    from kubernetes_autoscaler_tpu_torch.utils.testing import build_test_pod

    tmp = repo_dir("journal_")
    proc = None
    try:
        fake = loop_world(LOOP_NODES, LOOP_PODS)
        fake.add_pod(build_test_pod("unfit-0", cpu_milli=32000, mem_mib=512,
                                    owner_name="unfit"))
        scenario = os.path.join(tmp, "scenario.json")
        with open(scenario, "w") as f:
            json.dump(scenario_doc(fake), f)
        jdir = os.path.join(tmp, "journal")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        cmd = [sys.executable, "-c", ENTRY_SHIM, "--scenario", scenario,
               "--max-iterations", str(ENTRY_ITERATIONS),
               "--scan-interval", "1s", "--journal-dir", jdir,
               "--journal-max-mb", str(JOURNAL_MAX_MB), "--shadow-audit=true",
               "--shadow-audit-dir", os.path.join(tmp, "audit"),
               "--address", f"127.0.0.1:{port}",
               "--leader-elect-lease-file", os.path.join(tmp, "lease"),
               *LOOP_FLAGS]
        # its output goes to files: a pipe nobody reads while the loop runs
        # could fill and stall it
        out_path = os.path.join(tmp, "entry.out")
        t0 = time.perf_counter()
        with open(out_path, "w") as out_f:
            proc = subprocess.Popen(cmd, stdout=out_f,
                                    stderr=subprocess.STDOUT, text=True)
        # /healthz once it answers; /metrics once a loop has run (before
        # that the registry holds no loop's families)
        scraped = {}
        deadline = time.perf_counter() + 900
        while proc.poll() is None and time.perf_counter() < deadline:
            if b"function_duration_seconds" in scraped.get("/metrics",
                                                           (0, b""))[1]:
                break
            for path in ("/healthz", "/metrics"):
                if path == "/healthz" and path in scraped:
                    continue
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}{path}", timeout=5) as r:
                        scraped[path] = (r.status, r.read())
                except urllib.error.HTTPError as e:
                    scraped[path] = (e.code, e.read())
                except OSError:
                    break
            time.sleep(0.2)
        proc.wait(timeout=max(deadline - time.perf_counter(), 1))
        entry_s = time.perf_counter() - t0
        with open(out_path) as f:
            output = f.read()
        k1 = [ln for ln in output.splitlines()
              if ln.startswith("K1 launches")]
        log(f"[entry] python -m kubernetes_autoscaler_tpu_torch --scenario "
            f"({LOOP_NODES} nodes, {LOOP_PODS + 2 * LOOP_NODES + 1} pods) "
            f"--max-iterations {ENTRY_ITERATIONS} --journal-dir "
            f"--shadow-audit=true: exit {proc.returncode} in {entry_s} s, "
            f"{k1[-1] if k1 else 'K1 launches not reported'}; /healthz "
            f"{scraped.get('/healthz', ('not scraped',))[0]}, /metrics "
            f"{scraped.get('/metrics', ('not scraped',))[0]} "
            f"({len(scraped.get('/metrics', (0, b''))[1])} B) ({card})")
        if proc.returncode != 0:
            raise AssertionError(f"[entry] exit {proc.returncode}: "
                                 f"{output[-4000:]}")
        if scraped.get("/healthz", (0,))[0] != 200 or \
                scraped.get("/metrics", (0,))[0] != 200 or \
                b"function_duration_seconds" not in scraped["/metrics"][1]:
            raise AssertionError(f"[entry] scrapes {scraped.keys()}")

        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m",
                            "kubernetes_autoscaler_tpu_torch.replay", jdir],
                           capture_output=True, text=True, timeout=900)
        replay_s = time.perf_counter() - t0
        report = json.loads(r.stdout) if r.returncode in (0, 2) else {}
        log(f"[entry] python -m kubernetes_autoscaler_tpu_torch.replay: exit "
            f"{r.returncode} in {replay_s} s, {report.get('loops')} loops, "
            f"zeroDrift {report.get('zeroDrift')}, audit divergences "
            f"{report.get('audit', {}).get('divergences')} ({card})")
        if r.returncode != 0:
            raise AssertionError(f"[entry] replay exit {r.returncode}: "
                                 f"{r.stderr[-4000:]}")

        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m",
                            "kubernetes_autoscaler_tpu_torch.lineage", jdir,
                            "--json", "why", "unfit-0"],
                           capture_output=True, text=True, timeout=300)
        why = json.loads(r.stdout) if r.returncode in (0, 1) else {}
        log(f"[entry] python -m kubernetes_autoscaler_tpu_torch.lineage why "
            f"unfit-0: exit {r.returncode} in {time.perf_counter() - t0} s, "
            f"{len(why.get('entries') or [])} entries, reason "
            f"{(why.get('entries') or [{}])[-1].get('reason')} ({card})")
        if r.returncode != 0:
            raise AssertionError(f"[entry] lineage exit {r.returncode}: "
                                 f"{r.stderr[-4000:]}")
        if not k1 or int(k1[-1].split()[-1]) == 0:
            raise AssertionError("the entry's loops launched K1 no time")
        return int(k1[-1].split()[-1])
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


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
    """(waves, flag reads) of the wave placer's plain version (the CPU
    route; both stay 0 on the card)."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels.constrained_kernel import (
        place_lanes,
    )

    return place_lanes.waves, place_lanes.flag_reads


def constrained_world(dims):
    """The constrained bench world on the card: (enc, groups, step), `step`
    one `run_once_fused` with the constrained tier (on_phase optional)."""
    from kubernetes_autoscaler_tpu_torch.ops import autoscale_step

    enc, groups = build_world(NODES, PODS, POD_GROUPS, NODEGROUPS,
                              RESIDENTS_PER_NODE, DEVICE, constrained=True)
    limit_cap = torch.full((groups.ng,), MAX_NEW_NODES, dtype=torch.int32,
                           device=DEVICE)

    def step(on_phase=None):
        return autoscale_step.run_once_fused(
            enc.nodes, enc.specs, enc.scheduled, groups, limit_cap, dims,
            max_new_nodes=MAX_NEW_NODES, max_pods_per_node=MAX_PODS_PER_NODE,
            planes=enc.planes, with_constraints=True, on_phase=on_phase)

    return enc, groups, step


def constrained_steps(card, step, snap=None):
    """CON_STEPS timed steps after the caller's warm-up: step ms (host clock
    to a synchronize), phase ms (CUDA events), the plain version's waves and
    flag reads per phase and, with `snap` (a device-side copy of the
    kernel's wave counter, taken without a host read), the kernel's waves
    per phase. Returns (step_ms, phase_ms, stats, last output)."""
    from kubernetes_autoscaler_tpu_torch.ops import autoscale_step

    bounds = list(autoscale_step.PHASES) + ["end"]
    step_ms, phase_ms = [], {p: [] for p in autoscale_step.PHASES}
    stats = {k: {p: [] for p in autoscale_step.PHASES}
             for k in ("waves", "reads", "kernel_waves")}
    out = None
    for _ in range(CON_STEPS):
        events, counts, snaps = {}, {}, {}

        def on_phase(name, events=events, counts=counts, snaps=snaps):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name] = ev
            counts[name] = wave_counts()
            if snap is not None:
                snaps[name] = snap()

        t0 = time.perf_counter()
        out = step(on_phase)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for a, b in zip(bounds, bounds[1:]):
            phase_ms[a].append(events[a].elapsed_time(events[b]))
            stats["waves"][a].append(counts[b][0] - counts[a][0])
            stats["reads"][a].append(counts[b][1] - counts[a][1])
            if snap is not None:
                stats["kernel_waves"][a].append(int(snaps[b]) - int(snaps[a]))
    log(f"[constrained] step ms over {CON_STEPS} steps: {step_ms}; p50 "
        f"{pct(step_ms, 50)} p90 {pct(step_ms, 90)} ({card})")
    for p in autoscale_step.PHASES:
        kw = (f", kernel lane-waves a step {sorted(set(stats['kernel_waves'][p]))}"
              if snap is not None else "")
        log(f"[constrained] phase {p} ms (CUDA events): p50 "
            f"{pct(phase_ms[p], 50)} p90 {pct(phase_ms[p], 90)}; plain waves "
            f"a step {sorted(set(stats['waves'][p]))}, flag reads a step "
            f"{sorted(set(stats['reads'][p]))}{kw} ({card})")
    return step_ms, phase_ms, stats, out


def record_con_calls(step):
    """One step with the kernels' wrappers recording the inputs of the
    filter pack (the first pack_lanes of one lane), the options pack (the
    first of several lanes) and the constrained drain sweep (the drain
    kernel's one call with a topology). Returns ({name: args} of the wave
    placer's calls, (SweepInputs, TopoInputs, K) of the sweep)."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import constrained_kernel
    from kubernetes_autoscaler_tpu_torch.ops.kernels import drain_kernel

    got, sweeps = {}, []
    real_pack = constrained_kernel.pack_lanes
    real_sweep = drain_kernel.sweep

    def pack(*a):
        got.setdefault("filter" if a[0].shape[0] == 1 else "options", a)
        return real_pack(*a)

    def sweep(inp, kk, explain, chunk=None, topo=None):
        sweeps.append((inp, topo, kk, explain))
        return real_sweep(inp, kk, explain, chunk, topo)

    constrained_kernel.pack_lanes, drain_kernel.sweep = pack, sweep
    try:
        step()
        torch.cuda.synchronize()
    finally:
        constrained_kernel.pack_lanes, drain_kernel.sweep = real_pack, real_sweep
    missing = {"filter", "options"} - set(got)
    if missing:
        raise AssertionError(f"the constrained step made no {missing} call")
    if len(sweeps) != 1 or sweeps[0][1] is None or sweeps[0][3]:
        raise AssertionError(f"the constrained step made {len(sweeps)} drain "
                             f"sweeps, not one with a topology")
    inp, topo, kk, _ = sweeps[0]
    log(f"[constrained] recorded the kernels' inputs: filter, options, the "
        f"drain sweep with a topology (C={inp.candidates.shape[0]} "
        f"N={inp.free.shape[0]} G={inp.req.shape[0]} MPN={inp.mpn} K={kk} "
        f"Z={topo.max_zones})")
    return got, (inp, topo, kk)


def pack_outputs(pack, args):
    """A recorded pack_lanes call through `pack` (the kernel's wrapper or
    its plain version): a flat tuple of outputs."""
    res = pack(*args)
    return res.free_after, res.placed, res.scheduled


def check_con(name, got, want) -> int:
    """Byte equality of the kernel's outputs with the plain version's;
    returns the max abs difference."""
    err = 0
    for k, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{name}: output {k} {g.dtype}"
                                 f"{tuple(g.shape)} vs {w.dtype}"
                                 f"{tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: output {k} differs from the plain "
                                 f"version")
    log(f"[kernels] constrained wave placer == plain: {name}")
    return err


def check_place_group(card) -> tuple[int, dict]:
    """`ops/constrained.place_group_constrained` at [constrained]'s width
    (con_cases.group_case: N = 5,120, R = 8, one zone-spread group) on the
    card: one launch of the place entry, no read to the host, byte-equal
    to the plain version on the CPU; its device time, as launched, the
    plain version's (`place_lanes_plain`) on the card and the bound (each
    input read once, each output written once; 4R + 40 operations on every
    node of every lane-wave, the kernel's wave counter, as `con_bound`).
    Returns (the max abs difference, its JSON fields)."""
    from kubernetes_autoscaler_tpu_torch.ops import constrained
    from kubernetes_autoscaler_tpu_torch.ops.kernels import con_cases
    from kubernetes_autoscaler_tpu_torch.ops.kernels import (
        constrained_kernel as ck,
    )

    args = con_cases.group_case()
    want = constrained.place_group_constrained(*args)
    dev = [a.to(DEVICE) if isinstance(a, torch.Tensor) else a for a in args]
    dev[5] = constrained.GroupConstraints(
        **{k: v.to(DEVICE) for k, v in vars(args[5]).items()})
    before = ck.launch.launches
    torch.cuda.synchronize()
    with no_host_reads():
        got = constrained.place_group_constrained(*dev)
    torch.cuda.synchronize()
    if ck.launch.launches != before + 1:
        raise AssertionError("place_group_constrained: expected one launch")
    err = check_con("place_group_constrained N=5120 R=8, a zone spread",
                    [g.cpu() for g in got], want)

    def place():
        constrained.place_group_constrained(*dev)

    free, feas, req, want_t, limit, cons, z = dev
    lane = constrained.GroupConstraints(
        **{k: v[None] for k, v in vars(cons).items()})

    def plain():
        ck.place_lanes_plain(free[None], feas[None], req[None],
                             want_t.reshape(1), limit.reshape(1), lane, z)

    counter = ck.wave_counter(DEVICE)
    counter.zero_()
    place()
    torch.cuda.synchronize()
    lane_waves = int(counter)
    n, r = free.shape
    in_bytes = sum(t.numel() * t.element_size() for t in
                   [free, feas, req, want_t, limit, *vars(cons).values()])
    t_bytes = (in_bytes + n * r * 4 + n * 4) / H100_BYTES_PER_S * 1e3
    t_ops = lane_waves * n * (4 * r + 40) / H100_OPS_PER_S * 1e3
    bound, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                       else (t_ops, "operations"))
    t = {"place_device_ms": cuda_ms(place, REPS, hold=True),
         "place_ms": cuda_ms(place, REPS),
         "place_plain_ms": cuda_ms(plain, 3, warmup=1),
         "place_bound_ms": bound, "place_bound_by": bound_by,
         "place_lane_waves": lane_waves}
    log(f"[kernels] constrained wave placer place_group_constrained (the "
        f"place entry, B=1 N={n} R={r}, {lane_waves} lane-waves): "
        f"{t['place_device_ms']} ms device time, {t['place_ms']} ms as "
        f"launched from Python; plain {t['place_plain_ms']} ms on the card; "
        f"bound {bound} ms ({bound_by}) ({card})")
    return err, t


def con_bound(args, lane_waves):
    """(bound ms, 'bytes'|'operations') of one pack_lanes call of the kernel
    on these inputs: each input read once (a shared row once), each output
    written once; operations: 4R integer ops a resource (clamp, divide,
    min, update) and 40 more for the gates, caps and scans on every node of
    every wave a lane ran (`lane_waves`, the kernel's count for this call),
    plus 4R + 8 on every node of every (lane, group) that takes the
    one-shot first fit."""
    free = args[0]
    b, n, r = free.shape
    g = args[2].shape[0]
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    tensors += list(vars(args[6]).values())
    in_bytes = 0.0
    for t in tensors:
        if t.dim() and t.shape[0] > 1 and t.stride(0) == 0:
            t = t[0]                               # a shared row, read once
        in_bytes += t.numel() * t.element_size()
    out_bytes = (b * n * r + b * g * n + b * g) * 4
    fast = b * g - int(args[6].is_constrained().expand(b, g).sum())
    ops = lane_waves * n * (4 * r + 40) + fast * n * (4 * r + 8)
    t_bytes = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def con_times(name, args, plain_reps):
    """The kernel's times on a recorded pack_lanes call: as launched from
    Python and device time (the stream held while the host enqueues), the
    plain version's on the card, the lane-waves of one call and the
    bound."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import constrained_kernel as ck

    def kernel():
        return ck.pack_lanes(*args)

    def plain():
        return ck.pack_lanes_plain(*args)

    counter = ck.wave_counter(DEVICE)
    counter.zero_()
    kernel()
    torch.cuda.synchronize()
    lane_waves = int(counter)
    bound, bound_by = con_bound(args, lane_waves)
    b, n, r = args[0].shape
    t = {"launch": cuda_ms(kernel, REPS), "kernel": cuda_ms(kernel, REPS,
                                                             hold=True),
         "plain": cuda_ms(plain, plain_reps, warmup=1), "bound": bound,
         "bound_by": bound_by, "lane_waves": lane_waves,
         "shape": (b, n, r, args[7])}
    cfg = ck.config(*t["shape"])
    log(f"[kernels] constrained wave placer {name} (pack_lanes B={b} "
        f"N={n} R={r}, {lane_waves} lane-waves a call; a cluster of "
        f"{cfg['cluster']} CTAs of {cfg['threads']} threads a lane, "
        f"{cfg['smem']} B of shared memory a CTA): kernel {t['kernel']} ms device time, "
        f"{t['launch']} ms as launched from Python; plain {t['plain']} ms on "
        f"the card; bound {bound} ms ({bound_by})")
    return t


def constrained_phase(dims, card, profile_dir=None):
    """Phase 14: `run_once_fused` with the constrained tier on the bench
    world with constraints (bench_pod_factory): the wave placer's kernel
    against its plain version on the step's own inputs (the filter pack,
    the options pack), the drain kernel's topology mode against its plain
    version on the step's sweep and on a world of the same widths where
    every lane re-places by waves; step and phase times with the kernels'
    launches and lane-waves; one step with no host read; the kernels' and
    the plain versions' times; one step under torch.profiler; invariants
    and the decision; row P on the step's plane calls and the step with the
    plain plane (`pred_phase`); `run_once_sim` with constraints. Returns
    (the wave placer's launches, its JSON fields, its max abs error, the
    topology mode's JSON fields with its launches and max abs error, row
    P's fields with its launches and max abs error)."""
    from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
        ClusterTensors,
    )
    from kubernetes_autoscaler_tpu_torch.ops import autoscale_step
    from kubernetes_autoscaler_tpu_torch.ops.kernels import (
        constrained_kernel as ck,
    )
    from kubernetes_autoscaler_tpu_torch.ops.kernels import (
        drain_kernel,
        drain_topo_cases,
        pack_kernel,
        predicate_kernel,
    )

    t0 = time.perf_counter()
    enc, groups, step = constrained_world(dims)
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

    step()                                               # warm-up
    torch.cuda.synchronize()
    # the kernel against its plain version (called directly, on the card)
    # on the inputs this step gives it
    calls, (dinp, dtopo, dkk) = record_con_calls(step)
    err = 0
    for name, args in calls.items():
        err = max(err, check_con(f"[constrained] {name} inputs",
                                 pack_outputs(ck.pack_lanes, args),
                                 pack_outputs(ck.pack_lanes_plain, args)))
    # the drain kernel's topology mode on the step's sweep, and on a world
    # of the same widths where every lane with pods re-places by waves
    n, r = dinp.free.shape
    d_err, step_lanes, _ = check_drain_topo("[constrained] sweep inputs",
                                            dinp, dtopo, dkk)
    every = drain_topo_cases.world(0, n, dinp.req.shape[0], dinp.mpn, kk=dkk,
                                   r=r, z=dtopo.max_zones).to(DEVICE)
    ainp, atopo = every.inputs()
    del every
    e, all_lanes, _ = check_drain_topo("[constrained] widths, every lane active",
                                       ainp, atopo, dkk)
    d_err = max(d_err, e)
    log(f"[constrained] drain lanes re-placed by waves: {step_lanes} in the "
        f"step's sweep, {all_lanes} where every lane is active ({card})")
    torch.cuda.synchronize()

    # the main path: counts zeroed just before, read just after
    counter = ck.wave_counter(DEVICE)
    d_counter = drain_kernel.wave_counter(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    pack_kernel.pack_groups_batched.launches = 0
    ck.launch.launches = 0
    drain_kernel.launch.launches = 0
    predicate_kernel.launch.launches = 0
    counter.zero_()
    d_counter.zero_()
    w0 = wave_counts()
    plain_lanes = drain_kernel.sweep_plain.active_lanes
    step_ms, phase_ms, stats, (decision, resident) = constrained_steps(
        card, step, snap=counter.clone)
    launches = ck.launch.launches
    d_launches = drain_kernel.launch.launches
    p_launches = predicate_kernel.launch.launches
    torch.cuda.synchronize()
    lane_waves = int(counter)
    d_waves, d_lanes = d_counter.tolist()
    w1 = wave_counts()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    k1 = pack_kernel.pack_groups_batched.launches
    log(f"[constrained] the wave placer's kernel: {launches} launches in "
        f"{CON_STEPS} steps ({launches / CON_STEPS} a step), {lane_waves} "
        f"lane-waves ({lane_waves / CON_STEPS} a step); the plain version's "
        f"waves {w1[0] - w0[0]} and flag reads {w1[1] - w0[1]} ({card})")
    log(f"[constrained] peak device memory allocated: {peak_mib:.1f} MiB; "
        f"K1 launches {k1} in {CON_STEPS} steps (the constrained pack "
        f"replaces it) ({card})")
    log(f"[constrained] the drain kernel: {d_launches} launches in "
        f"{CON_STEPS} steps ({d_launches / CON_STEPS} a step), {d_lanes} "
        f"lanes re-placed by waves in them ({d_waves} lane-waves); the plain "
        f"sweep's lanes {drain_kernel.sweep_plain.active_lanes - plain_lanes} "
        f"({card})")
    if k1:
        raise AssertionError("K1 ran on the constrained path")
    if launches != 2 * CON_STEPS or not lane_waves:
        raise AssertionError(f"the wave placer launched {launches} times in "
                             f"{CON_STEPS} steps, not 2 a step (the filter "
                             f"and the options)")
    if d_launches != CON_STEPS:
        raise AssertionError(f"the drain kernel launched {d_launches} times "
                             f"in {CON_STEPS} steps, not once a step")
    if w1 != w0 or drain_kernel.sweep_plain.active_lanes != plain_lanes:
        raise AssertionError("a plain version ran on the card")
    log(f"[constrained] predicate plane (row P) launches: {p_launches} in "
        f"{CON_STEPS} steps ({p_launches / CON_STEPS} a step: 3 planes and 4 "
        f"selector planes) ({card})")
    if p_launches != 7 * CON_STEPS:
        raise AssertionError(f"row P launched {p_launches} times in "
                             f"{CON_STEPS} steps, not 7 a step")

    # one step with no host read at all
    r0 = wave_counts()
    with no_host_reads():
        step()
    torch.cuda.synchronize()
    reads = wave_counts()[1] - r0[1]
    log(f"[constrained] one step under torch.cuda sync debug mode 'error': "
        f"no host read, flag reads {reads}")
    if reads:
        raise AssertionError(f"{reads} flag reads on the card")

    # the kernel's and the plain version's times on the step's inputs (the
    # plain version at the filter's inputs is the route the card took
    # before the kernel)
    times = {name: con_times(name, args, 3) for name, args in calls.items()}
    del calls
    d_times = {"sweep": drain_topo_times("[constrained] sweep", dinp, dtopo,
                                         dkk, card, plain_reps=2),
               "all_active": drain_topo_times(
                   "[constrained] widths, every lane active", ainp, atopo, dkk,
                   card)}
    del ainp, atopo

    profile_step(step, pct(step_ms, 50), profile_dir, tag="[constrained]",
                 trace_name="chip_smoke_constrained_step.trace.json")
    # row P on the step's own plane calls; the step with the plain plane
    pred_entry, p_err = pred_phase(card, "[constrained]", step, 7)

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
    f = times["filter"]
    entry = {"ms": f["launch"], "device_ms": f["kernel"],
             "plain_ms": f["plain"], "bound_ms": f["bound"],
             "bound_by": f["bound_by"],
             "lane_waves": lane_waves, "lane_waves_per_step":
                 lane_waves / CON_STEPS,
             "launches_per_step": launches / CON_STEPS,
             "step_p50_ms": pct(step_ms, 50), "step_p90_ms": pct(step_ms, 90),
             "filter_p50_ms": pct(phase_ms["filter"], 50)}
    t = times["options"]
    entry.update({"options_ms": t["launch"], "options_device_ms": t["kernel"],
                  "options_plain_ms": t["plain"],
                  "options_bound_ms": t["bound"]})
    for name, t in times.items():   # the launch each pack took
        cfg = ck.config(*t["shape"])
        entry[f"{name}_cluster"] = cfg["cluster"]
        entry[f"{name}_threads"] = cfg["threads"]
    t = d_times["sweep"]
    d_entry = {"launches": d_launches, "max_abs_err": d_err,
               "ms": t["launch"], "device_ms": t["kernel"],
               "plain_ms": t["plain"], "bound_ms": t["bound"],
               "bound_by": t["bound_by"], "nodes_needed": t["nodes_needed"],
               "lane_waves": t["lane_waves"], "waved_lanes": t["waved_lanes"],
               "main_path_waved_lanes": d_lanes,
               "main_path_lane_waves": d_waves}
    t = d_times["all_active"]
    d_entry.update({f"all_active_{k}": t[k2] for k, k2 in (
        ("ms", "launch"), ("device_ms", "kernel"), ("plain_ms", "plain"),
        ("bound_ms", "bound"), ("bound_by", "bound_by"),
        ("lane_waves", "lane_waves"), ("waved_lanes", "waved_lanes"))})
    pred_entry.update({"launches": p_launches, "max_abs_err": p_err})
    return launches, entry, err, d_entry, pred_entry


def constrained_cpu_card_phase(dims, card):
    """Phase 14: the constrained steps on the CPU and on the card on the
    every-kind world (kinds_objects) at 512 nodes, with the drain lanes that
    re-placed by waves (the plain sweep's count on the CPU, the drain
    kernel's on the card)."""
    from kubernetes_autoscaler_tpu_torch.ops import autoscale_step
    from kubernetes_autoscaler_tpu_torch.ops.kernels import drain_kernel

    runs = {}
    for dev in ("cpu", DEVICE):
        e, gr = encode_world(kinds_objects(SMALL_NODES), dev)
        cap = torch.full((gr.ng,), MAX_NEW_NODES, dtype=torch.int32,
                         device=dev)
        d_counter = drain_kernel.wave_counter(dev)
        d_counter.zero_()
        plain_lanes = drain_kernel.sweep_plain.active_lanes
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
        lanes = (drain_kernel.sweep_plain.active_lanes - plain_lanes
                 if dev == "cpu" else int(d_counter[1]))
        wave_row = int((e.specs.count == KINDS_WAVE_PODS).nonzero()[0])
        capped = int(fused[0].verdict[wave_row])
        log(f"[constrained-cpu-card] {dev}: kinds "
            f"{json.dumps(constraint_kinds(e))}; waves {w1[0] - w0[0]}, flag "
            f"reads {w1[1] - w0[1]}; the one-zone spread placed {capped} of "
            f"{KINDS_WAVE_PODS}; drain lanes re-placed by waves in the fused "
            f"step and scale_down_sim: {lanes} "
            f"({'the plain sweep' if dev == 'cpu' else 'the drain kernel'})")
        runs.setdefault("lanes", []).append(lanes)
        if capped != 128:
            raise AssertionError(f"the one-zone spread placed {capped}, not "
                                 f"the MAX_WAVES cap of 128")
        runs[dev] = {"run_once_fused": fused, "scale_up_sim": up,
                     "scale_down_sim": down}
    if runs.pop("lanes") != [lanes] * 2:
        raise AssertionError("the CPU and the card re-placed different drain "
                             "lanes by waves")
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


def con_launches():
    """The wave placer kernel's launches so far; None for a port without the
    kernel (an older tree measured by tools/torch_loop_ab.py)."""
    try:
        from kubernetes_autoscaler_tpu_torch.ops.kernels import (
            constrained_kernel,
        )
    except ImportError:
        return None
    return constrained_kernel.launch.launches


def loop_constrained_phase(card):
    """Phase 15: the control loop on the constrained bench world at full
    width with [loop]'s churn: one cold loop, CON_LOOP_STEPS timed.
    Returns (loop ms, {phase: share of the loops' time})."""
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
        c0 = con_launches()
        s0 = dict(hist._sums)
        t0 = time.perf_counter()
        st = a.run_once(now=1010.0 + 10.0 * loop)
        ms.append((time.perf_counter() - t0) * 1e3)
        w1 = wave_counts()
        c1 = con_launches()
        spans = {k[0][1]: (v - s0.get(k, 0.0)) * 1e3
                 for k, v in hist._sums.items()}
        rows.append({"loop": loop, "ms": ms[-1], "fused_mode": st.fused_mode,
                     "speculation": st.speculation,
                     "round_trips": st.loop_device_round_trips,
                     "encode": f"{a._world_store.last_mode}/"
                               f"{a._world_store.last_cause}",
                     "h2d_bytes": a._world_store.last_h2d_bytes,
                     "waves": w1[0] - w0[0], "reads": w1[1] - w0[1],
                     "con_launches": None if c0 is None else c1 - c0,
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
            f"{r['h2d_bytes']} B, plain waves {r['waves']}, flag reads "
            f"{r['reads']}, wave-placer kernel launches {r['con_launches']} "
            f"(real and speculative dispatch), host ms "
            f"{json.dumps(r['spans'])}, scaled up {r['scaled_up']}, pending "
            f"{r['pending']} ({card})")
    log(f"[loop-constrained] loop ms over {CON_LOOP_STEPS} loops: p50 "
        f"{pct(ms, 50)} p90 {pct(ms, 90)}; K1 launches "
        f"{pack_kernel.pack_groups_batched.launches} ({card})")
    sums = {k[0][1]: v - sums0.get(k[0][1], 0.0)
            for k, v in hist._sums.items()}
    total = sum(ms) / 1e3
    shares = {}
    for name in ("snapshot_build", "fused_dispatch", "fused_harvest",
                 "scale_up", "scale_down_update", "scale_down_confirm",
                 "speculative_dispatch", "main"):
        v = sums.get(name, 0.0)
        shares[name] = v / total
        log(f"[loop-constrained] phase {name} total {v} s over "
            f"{CON_LOOP_STEPS} loops ({100.0 * v / total:.1f} % of the "
            f"loops' time) ({card})")
    if any(r["fused_mode"] != "fused" for r in rows):
        raise AssertionError("a constrained loop ran phased")
    if any(r["round_trips"] > 2 for r in rows):
        raise AssertionError("a constrained loop took more than 2 round trips")
    if not native_confirm.available():
        raise AssertionError("the native confirmation is not available")
    return ms, shares


def loop_constrained_cpu_card_phase(card):
    """Phase 16: the constrained loop world at 512 nodes with unneeded time
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


# ---------------------------------------------------------------- sidecar

SIDE_LARGE = 4            # large tenants: [loop]'s world each
SIDE_SMALL = 4            # small tenants
SIDE_SMALL_NODES = 1000
SIDE_SMALL_PODS = 10000
SIDE_LANES = 4            # the batched service's batch_lanes
SIDE_WINDOW_MS = 25.0     # its batch_window_ms
SIDE_WINDOW_MAX = 8       # its batch_window_max
SIDE_WARM = 2             # warm-up rounds of each kind
SIDE_UP_ROUNDS = 5        # timed ScaleUpSim rounds
SIDE_DOWN_ROUNDS = 2      # timed ScaleDownSim rounds
SIDE_THRESHOLD = 0.5
SIDE_MAX_NEW = 256
SIDE_CHURN = 500          # pending pods replaced by the churn delta
SIDE_CHUNK = 2000         # objects a DeltaWriter chunk writes
SIDE_WHATIF_T = 4         # loops of the WhatIf rollout
SIDE_CPU_CARD_NODES = 256


def side_node_groups():
    """Every request's node groups: [loop]'s ng1 template and bench.py's
    sidecar templates (bench.py:1487-1494)."""
    mib = 1024 * 1024
    return [
        {"id": "ng1", "template": {"name": "tmpl", "capacity": {
            "cpu": 16.0, "memory": 65536 * mib, "pods": 110}},
         "max_new": 4 * LOOP_NODES, "price": 1.0},
        {"id": "ng-4c", "template": {"name": "t4", "capacity": {
            "cpu": 4.0, "memory": 16384 * mib, "pods": 110}},
         "max_new": 32, "price": 1.0},
        {"id": "ng-8c", "template": {"name": "t8", "capacity": {
            "cpu": 8.0, "memory": 32768 * mib, "pods": 110}},
         "max_new": 32, "price": 1.9},
    ]


def kad1_merge(payloads):
    """One KAD1 payload from payloads written in order by separate
    DeltaWriters: the op counts add, the bodies concatenate and the KAUX
    trailers merge, so the result is the bytes one writer would write for
    the same calls. (A writer scans its aux delete list once per unlabelled
    pod, so one writer of a whole world takes time quadratic in its pods;
    chunks keep each scan short.)"""
    import struct
    import zlib

    from kubernetes_autoscaler_tpu_torch.sidecar.wire import (
        AUX_MAGIC,
        MAGIC,
        split_aux,
    )

    count, bodies, up, dels = 0, [], {}, []
    for p in payloads:
        dense, aux = split_aux(p)
        if dense[:4] != MAGIC:
            raise AssertionError("kad1_merge: not a KAD1 payload")
        count += struct.unpack("<I", dense[4:8])[0]
        bodies.append(dense[8:])
        if aux is not None:
            up.update(aux["up"])
            dels.extend(aux["del"])
    out = MAGIC + struct.pack("<I", count) + b"".join(bodies)
    if up or dels:
        doc = json.dumps({"up": up, "del": dels}).encode()
        out += (doc + struct.pack("<I", len(doc))
                + struct.pack("<I", zlib.crc32(doc)) + AUX_MAGIC)
    return out


def side_world_calls(n_nodes, n_pods):
    """loop_world's objects as DeltaWriter calls, in order: nodes of 16 CPU
    / 64 GiB / 110 pods, two movable residents on each, `n_pods` pending
    pods (loop_pod)."""
    from kubernetes_autoscaler_tpu_torch.utils.testing import (
        build_test_node,
        build_test_pod,
    )

    for i in range(n_nodes):
        yield "node", build_test_node(f"n{i}", cpu_milli=16000,
                                      mem_mib=65536, pods=110)
    for i in range(n_nodes):
        per_pod = 1600 if i < n_nodes // 16 else 3200
        for j in range(2):
            yield "resident", build_test_pod(
                f"r{i}-{j}", cpu_milli=per_pod, mem_mib=1024,
                owner_name=f"rs{i % 17}", node_name=f"n{i}")
    for i in range(n_pods):
        yield "pod", loop_pod(i, i)


def side_payload(calls, chunk=SIDE_CHUNK):
    """The calls written in chunks of `chunk` and merged (kad1_merge)."""
    from kubernetes_autoscaler_tpu_torch.sidecar.wire import DeltaWriter

    payloads, w, k = [], DeltaWriter(), 0
    for what, obj in calls:
        if what == "node":
            w.upsert_node(obj)
        elif what == "delete":
            w.delete_pod(obj)
        else:
            w.upsert_pod(obj, movable=what == "resident")
        k += 1
        if k == chunk:
            payloads.append(w.payload())
            w, k = DeltaWriter(), 0
    payloads.append(w.payload())
    return kad1_merge(payloads)


def side_tenant_delta(i, tag):
    """Tenant i's own delta: 100 (i + 1) more pending pods in owner group
    i, and node i cordoned, so no two tenants hold the same world."""
    from kubernetes_autoscaler_tpu_torch.utils.testing import (
        build_test_node,
        build_test_pod,
    )

    node = build_test_node(f"n{i}", cpu_milli=16000, mem_mib=65536, pods=110)
    node.unschedulable = True
    calls = [("node", node)] + [
        ("pod", build_test_pod(f"{tag}-{k}", cpu_milli=500, mem_mib=512,
                               owner_name=f"prs{i % LOOP_POD_GROUPS}"))
        for k in range(100 * (i + 1))]
    return side_payload(calls)


def side_churn(n_pods):
    """SIDE_CHURN pending pods leave and as many arrive."""
    calls = [("delete", f"uid-default/p{k}") for k in range(SIDE_CHURN)]
    calls += [("pod", loop_pod(n_pods + k, k)) for k in range(SIDE_CHURN)]
    return side_payload(calls)


def side_strip(resp):
    if not isinstance(resp, dict):
        raise AssertionError(f"[sidecar] not a response: {resp!r}")
    if resp.get("error"):
        raise AssertionError(f"[sidecar] error response: {resp['error']}")
    # through JSON, as a client reads it
    return json.loads(json.dumps(
        {k: v for k, v in resp.items() if k not in ("lifecycle", "trace")}))


def compare_json(name, want, got, rtol=None, path="") -> int:
    """Two responses equal: keys, ids, ints and bools exactly; floats
    exactly too unless `rtol` is given. Returns the floats that differ at
    all (within rtol)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(want) != sorted(got):
            raise AssertionError(f"{name}{path}: keys differ")
        return sum(compare_json(name, want[k], got[k], rtol, f"{path}.{k}")
                   for k in want)
    if isinstance(want, list):
        if not isinstance(got, list) or len(want) != len(got):
            raise AssertionError(f"{name}{path}: lists differ in length")
        return sum(compare_json(name, a, b, rtol, f"{path}[{i}]")
                   for i, (a, b) in enumerate(zip(want, got)))
    if isinstance(want, float) and isinstance(got, float):
        if want == got:
            return 0
        if rtol is not None and abs(got - want) <= rtol * abs(want):
            return 1
        raise AssertionError(f"{name}{path}: {want!r} vs {got!r}")
    if type(want) is not type(got) or want != got:
        raise AssertionError(f"{name}{path}: {want!r} vs {got!r}")
    return 0


def side_round(svc, method, params, tenants):
    """One request per tenant, each on its own thread, released together
    by a barrier: {tenant: (stripped response, ms, the response's
    lifecycle phases in ms)}."""
    out, errs = {}, []
    barrier = threading.Barrier(len(tenants))

    def run(tid):
        try:
            barrier.wait()
            t0 = time.perf_counter()
            r = getattr(svc, method)(params, tenant=tid)
            out[tid] = (side_strip(r), (time.perf_counter() - t0) * 1e3,
                        r["lifecycle"]["phases_ms"])
        except Exception as e:  # noqa: BLE001 — raised below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in tenants]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errs:
        raise errs[0]
    return out


def side_services(device, lanes_list, **kw):
    """One SimulatorService per batch_lanes value, on `device`."""
    from kubernetes_autoscaler_tpu_torch.sidecar.server import SimulatorService

    return [SimulatorService(batch_lanes=lanes,
                             batch_window_ms=SIDE_WINDOW_MS,
                             batch_window_max=SIDE_WINDOW_MAX,
                             queue_depth=256, device=device, **kw)
            for lanes in lanes_list]


def side_kaux_payload(n_nodes):
    """A constrained (KAUX) tenant: nodes in two zones, a resident that a
    pending group's pod affinity points at, a zone-spread group."""
    from kubernetes_autoscaler_tpu_torch.models.api import (
        AffinityTerm,
        TopologySpreadConstraint,
    )
    from kubernetes_autoscaler_tpu_torch.sidecar.wire import DeltaWriter
    from kubernetes_autoscaler_tpu_torch.utils.testing import (
        build_test_node,
        build_test_pod,
    )

    w = DeltaWriter()
    for i in range(n_nodes):
        w.upsert_node(build_test_node(f"k{i}", cpu_milli=4000, mem_mib=8192,
                                      zone="ab"[i % 2]))
    w.upsert_pod(build_test_pod("db", cpu_milli=100, mem_mib=64,
                                labels={"app": "db"}, node_name="k1"))
    for i in range(3 * n_nodes):
        p = build_test_pod(f"w{i}", cpu_milli=1500, mem_mib=64,
                           labels={"app": "w"}, owner_name="w-rs")
        p.pod_affinity = [AffinityTerm(match_labels={"app": "db"},
                                       topology_key=ZONE_KEY)]
        w.upsert_pod(p)
        p = build_test_pod(f"s{i}", cpu_milli=500, mem_mib=64,
                           labels={"app": "s"}, owner_name="s-rs")
        p.topology_spread = [TopologySpreadConstraint(
            max_skew=1, topology_key=ZONE_KEY, match_labels={"app": "s"})]
        w.upsert_pod(p)
    return w.payload()


def side_what_if(svc, tenant, n_nodes, rollout):
    """The WhatIf request of the phase: bench.py's four variant kinds (the
    server prepends the null lane and pads to a rung), `rollout` loops of a
    quiet workload. Returns (request body, stripped report, ms)."""
    body = json.dumps({
        "node_groups": side_node_groups(), "max_new_nodes": SIDE_MAX_NEW,
        "variants": [v.to_dict() for v in whatif_variants(5, n_nodes)[1:]],
        "rollout": rollout, "workload": {"v": 1, "kind": "quiet"},
    }).encode()
    t0 = time.perf_counter()
    rep = side_strip(svc.what_if(body, tenant=tenant))
    return body, rep, (time.perf_counter() - t0) * 1e3


def side_what_if_direct(svc, tenant, body):
    """The same report from the port's whatif/ called directly on the
    tenant's resident tensors, as the server's WhatIf builds them."""
    from kubernetes_autoscaler_tpu_torch.ops.hostfetch import to_host
    from kubernetes_autoscaler_tpu_torch.sidecar.server import SimParams
    from kubernetes_autoscaler_tpu_torch.sidecar.shapes import rung
    from kubernetes_autoscaler_tpu_torch.whatif import (
        generator,
        kernel,
        report,
        variants,
    )

    raw = json.loads(body)
    params = SimParams(max_new_nodes=raw["max_new_nodes"],
                       node_groups=raw["node_groups"])
    ts = svc._tenant(tenant)
    nt, gt, pt, _planes, _c = svc._tensors_with_constraints(ts)
    groups, ids = svc._encode_groups(ts, params)
    branch = variants.Branch(
        nodes=nt, specs=gt, scheduled=pt, groups=groups,
        limit_cap=np.minimum(to_host(groups.max_new, np.int64),
                             np.int64(params.max_new_nodes)).astype(np.int32),
        statics={"dims": svc.dims, "max_new_nodes": params.max_new_nodes,
                 "max_pods_per_node": 128, "with_constraints": False},
        meta={"source": "tenant", "tenant": tenant, "groups": ids})
    vs = [variants.VariantSpec.from_dict(d) for d in raw["variants"]]
    lanes = variants.build_lanes(branch, vs, pad_to=rung(len(vs) + 1, 4))
    kw = dict(dims=svc.dims, max_new_nodes=params.max_new_nodes,
              max_pods_per_node=128, strategy=params.strategy)
    margs = (lanes.nodes, lanes.specs, lanes.scheduled, lanes.groups,
             lanes.limit_cap)
    decision, summary = kernel.multiverse_step(*margs, **kw)
    wl = generator.WorkloadSpec.from_record(raw["workload"])
    adds, fails = generator.generate_workload(
        wl, raw["rollout"], int(lanes.specs.count.shape[1]),
        int(lanes.nodes.valid.shape[1]))
    adds_b, fails_b = generator.lane_workloads(lanes.variants, adds, fails)
    traj = kernel.rollout_multiverse(*margs, lanes.thresholds, adds_b,
                                     fails_b, **kw)
    return report.build_report(lanes, summary=summary, decision=decision,
                               traj=traj, workload=wl)


def side_pct(rows):
    return (f"p50 {pct(rows, 50)} p90 {pct(rows, 90)} ms over {len(rows)}"
            if rows else "none")


def sidecar_phase(card, dims, kernel, plain):
    """Phase 18: the simulation sidecar serving a fleet on the card. Returns
    (K1 launches in the timed ScaleUpSim rounds, K1 launches per batch,
    the max abs err of K1 on a large lane's inputs, K1's times there)."""
    from kubernetes_autoscaler_tpu_torch.ops import hostfetch
    from kubernetes_autoscaler_tpu_torch.ops.autoscale_step import (
        scale_down_sim_batch,
        scale_up_sim_batch,
    )
    from kubernetes_autoscaler_tpu_torch.ops.binpack import option_pack_inputs
    from kubernetes_autoscaler_tpu_torch.ops.kernels import build, pack_kernel
    from kubernetes_autoscaler_tpu_torch.ops.schedule import (
        filter_pack_inputs,
        schedule_pending_on_existing,
    )
    from kubernetes_autoscaler_tpu_torch.sidecar import batch as b
    from kubernetes_autoscaler_tpu_torch.sidecar.server import SimParams
    from kubernetes_autoscaler_tpu_torch.sidecar.shapes import rung

    k1 = pack_kernel.pack_groups_batched
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()

    # the merged chunks are the bytes one writer writes
    small = list(side_world_calls(8, 60))
    if side_payload(small, chunk=7) != side_payload(small, chunk=10 ** 9):
        raise AssertionError("[sidecar] kad1_merge differs from one writer")
    t0 = time.perf_counter()
    large_payload = side_payload(side_world_calls(LOOP_NODES, LOOP_PODS))
    large_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    small_payload = side_payload(side_world_calls(SIDE_SMALL_NODES,
                                                  SIDE_SMALL_PODS))
    log(f"[sidecar] world payloads written: large {len(large_payload)} B "
        f"({LOOP_NODES} nodes, {2 * LOOP_NODES} residents, {LOOP_PODS} "
        f"pending) in {large_s} s, small {len(small_payload)} B "
        f"({SIDE_SMALL_NODES} nodes, {SIDE_SMALL_PODS} pending) in "
        f"{time.perf_counter() - t0} s")

    svc, ser = side_services(DEVICE, (SIDE_LANES, 0))
    large = [f"large{i}" for i in range(SIDE_LARGE)]
    smalls = [f"small{i}" for i in range(SIDE_SMALL)]
    tenants = large + smalls
    apply_ms = {"world": [], "delta": []}
    delta_bytes = []
    for i, tid in enumerate(tenants):
        world = large_payload if tid in large else small_payload
        delta = side_tenant_delta(i, f"x{i}")
        delta_bytes.append(len(delta))
        for s in (svc, ser):
            t0 = time.perf_counter()
            ack = s.apply_delta(world, tenant=tid)
            ms_world = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            ack2 = s.apply_delta(delta, tenant=tid)
            ms_delta = (time.perf_counter() - t0) * 1e3
            if ack["error"] or ack2["error"] or ack2["version"] != 2:
                raise AssertionError(f"[sidecar] ApplyDelta {tid}: {ack} "
                                     f"{ack2}")
            if s is svc:
                apply_ms["world"].append((tid in large, ms_world))
                apply_ms["delta"].append(ms_delta)
    for cls in (True, False):
        log(f"[sidecar] ApplyDelta of the {'large' if cls else 'small'} "
            f"world: " + side_pct([m for c, m in apply_ms["world"]
                                   if c == cls]) + f" ({card})")
    log(f"[sidecar] ApplyDelta of a tenant's own delta ({min(delta_bytes)}-"
        f"{max(delta_bytes)} B): {side_pct(apply_ms['delta'])} ({card})")

    up = SimParams(max_new_nodes=SIDE_MAX_NEW, node_groups=side_node_groups())
    down = SimParams(threshold=SIDE_THRESHOLD)
    got = {}           # (step, kind, tenant) -> {tier: response}
    ms = {}            # (tier, kind, class) -> [ms]
    phases = {}        # (tier, kind) -> {lifecycle phase: [ms]}

    def run(tier, s, step, kind, who, timed):
        out = side_round(s, "scale_up_sim" if kind == "up" else
                         "scale_down_sim", up if kind == "up" else down, who)
        for tid, (resp, t, ph) in out.items():
            got.setdefault((step, kind, tid), {})[tier] = resp
            if timed:
                cls = "large" if tid in large else "small"
                ms.setdefault((tier, kind, cls), []).append(t)
                for name, v in ph.items():
                    phases.setdefault((tier, kind), {}).setdefault(
                        name, []).append(v)
        return out

    for tier, s in (("batched", svc), ("serial", ser)):
        for w in range(SIDE_WARM):
            run(tier, s, f"warm{w}", "up", tenants, False)
            run(tier, s, f"warm{w}", "down", tenants, False)

    # the timed window of the batched service
    h2d = svc.registry.counter("world_store_h2d_bytes_total")
    h2d0, cache0 = h2d.total(), build.cache_size()
    batches0 = svc._scheduler.batches
    torch.cuda.synchronize()
    hostfetch.reset_round_trips()
    k1.launches = 0
    d0 = drain_launches()
    t0 = time.perf_counter()
    for r in range(SIDE_UP_ROUNDS):
        run("batched", svc, f"up{r}", "up", tenants, True)
    up_s = time.perf_counter() - t0
    up_batches = svc._scheduler.batches - batches0
    up_launches = k1.launches
    d_up = drain_launches() - d0
    t0 = time.perf_counter()
    for r in range(SIDE_DOWN_ROUNDS):
        run("batched", svc, f"down{r}", "down", tenants, True)
    down_s = time.perf_counter() - t0
    batches = svc._scheduler.batches - batches0
    trips = hostfetch.round_trips()
    down_launches = k1.launches - up_launches
    d_down = drain_launches() - d0 - d_up
    if h2d.total() != h2d0:
        raise AssertionError(f"[sidecar] world h2d moved over the steady "
                             f"rounds: {h2d.total() - h2d0} B")
    if build.cache_size() != cache0:
        raise AssertionError("[sidecar] the kernel build cache grew over the "
                             "timed window")
    if trips != batches:
        raise AssertionError(f"[sidecar] {trips} fetches for {batches} "
                             f"batches")
    if up_launches == 0 or down_launches != 0:
        raise AssertionError(f"[sidecar] K1 launches: {up_launches} over the "
                             f"ScaleUpSim rounds, {down_launches} over the "
                             f"ScaleDownSim rounds")
    if d_down == 0:
        raise AssertionError("[sidecar] the ScaleDownSim rounds launched the "
                             "drain kernel no time")
    stats = svc.batch_stats()
    log(f"[sidecar] batched: {SIDE_UP_ROUNDS} ScaleUpSim rounds of "
        f"{len(tenants)} tenants in {up_s} s ({SIDE_UP_ROUNDS * len(tenants) / up_s} "
        f"sims/s), {SIDE_DOWN_ROUNDS} ScaleDownSim rounds in {down_s} s "
        f"({SIDE_DOWN_ROUNDS * len(tenants) / down_s} sims/s); {batches} "
        f"batches ({up_batches} ScaleUpSim), {trips} fetches, occupancy p50 "
        f"{stats['occupancy_p50']}, stack cache {stats['stack_cache']}; K1 "
        f"{up_launches} launches over the ScaleUpSim rounds "
        f"({up_launches / up_batches} a batch), 0 over ScaleDownSim; drain "
        f"kernel {d_up} launches over the ScaleUpSim rounds, {d_down} over "
        f"ScaleDownSim ({d_down / (batches - up_batches)} a batch); world "
        f"h2d 0 B, build cache {cache0} libraries before and after ({card})")

    t0 = time.perf_counter()
    for r in range(SIDE_UP_ROUNDS):
        run("serial", ser, f"up{r}", "up", tenants, True)
    ser_up_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for r in range(SIDE_DOWN_ROUNDS):
        run("serial", ser, f"down{r}", "down", tenants, True)
    ser_down_s = time.perf_counter() - t0
    log(f"[sidecar] serial: ScaleUpSim {SIDE_UP_ROUNDS * len(tenants) / ser_up_s} "
        f"sims/s ({ser_up_s} s), ScaleDownSim "
        f"{SIDE_DOWN_ROUNDS * len(tenants) / ser_down_s} sims/s "
        f"({ser_down_s} s) ({card})")
    for key in sorted(ms):
        log(f"[sidecar] ms per RPC {key[0]} {key[1]} {key[2]}: "
            f"{side_pct(ms[key])} ({card})")
    for key in sorted(phases):
        log(f"[sidecar] lifecycle phases {key[0]} {key[1]}, p50 ms: "
            + json.dumps({k: pct(v, 50) for k, v in phases[key].items()})
            + f" ({card})")
    # the serial tier with one request at a time: the per-sim cost without
    # eight threads contending for the interpreter and the stream
    alone = {"large": [], "small": []}
    for tid in tenants:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got.setdefault(("serial-alone", "up", tid), {})["serial"] = \
            side_strip(ser.scale_up_sim(up, tenant=tid))
        alone["large" if tid in large else "small"].append(
            (time.perf_counter() - t0) * 1e3)
        got[("serial-alone", "up", tid)]["batched"] = \
            got[(f"up{SIDE_UP_ROUNDS - 1}", "up", tid)]["batched"]
    log(f"[sidecar] ms per RPC serial up, one request at a time: large "
        f"{side_pct(alone['large'])}, small {side_pct(alone['small'])} "
        f"({card})")
    for tid in (large[0], smalls[0]):
        ts = svc._tenant(tid)
        log(f"[sidecar] class of {tid}: {ts.shape_class.key} (counts "
            f"{ts.state.counts()} nodes/pods/groups)")

    # a window with one member: padded to 4 lanes, lane 0 computed once
    k1.launches = 0
    run("batched", svc, "alone", "up", large[:1], False)
    ratio = svc.registry.gauge("batch_occupancy_ratio").value(kind="up")
    if ratio != 1 / SIDE_LANES or k1.launches != 2:
        raise AssertionError(f"[sidecar] a lone member: occupancy ratio "
                             f"{ratio}, K1 launches {k1.launches}")
    run("serial", ser, "alone", "up", large[:1], False)

    # a ninth tenant joins the large class
    ninth = f"large{SIDE_LARGE}"
    for s in (svc, ser):
        s.apply_delta(large_payload, tenant=ninth)
        s.apply_delta(side_tenant_delta(len(tenants), "x-ninth"),
                      tenant=ninth)
    run("batched", svc, "ninth", "up", large + [ninth], False)
    run("serial", ser, "ninth", "up", large + [ninth], False)
    recompiles = svc.batch_stats()["recompiles_per_new_tenant"]
    if recompiles != 0 or (svc._tenant(ninth).shape_class
                           != svc._tenant(large[0]).shape_class):
        raise AssertionError(f"[sidecar] the ninth tenant: "
                             f"recompiles_per_new_tenant {recompiles}")

    # churn on one large tenant: its dirty sections upload, nothing else
    ts = svc._tenant(large[0])
    keys0 = dict(ts.dev_keys)
    per0 = {t: h2d.value(tenant=t) for t in tenants}
    churn = side_churn(LOOP_PODS)
    t0 = time.perf_counter()
    ack = svc.apply_delta(churn, tenant=large[0])
    churn_ms = (time.perf_counter() - t0) * 1e3
    ser.apply_delta(churn, tenant=large[0])
    for kind in ("up", "down"):
        run("batched", svc, "churn", kind, large, False)
        run("serial", ser, "churn", kind, large, False)
    dirty = [sec for sec in ("nodes", "groups", "pods")
             if ts.dev_keys[sec] != keys0[sec]]
    want_bytes = sum(int(v.nbytes) for sec in dirty
                     for v in ts.export_np[sec].values())
    moved = {t: h2d.value(tenant=t) - per0[t] for t in tenants}
    if ack["error"] or moved[large[0]] != want_bytes or any(
            v for t, v in moved.items() if t != large[0]):
        raise AssertionError(f"[sidecar] churn h2d: {moved}, dirty sections "
                             f"{dirty} hold {want_bytes} B")
    log(f"[sidecar] churn delta of {2 * SIDE_CHURN} pod ops ({len(churn)} "
        f"B) applied in {churn_ms} ms; world h2d {want_bytes} B, the dirty "
        f"sections {dirty} of {large[0]} alone ({card})")

    # every member's response is the serial service's
    n = 0
    for key, by_tier in sorted(got.items()):
        if set(by_tier) != {"batched", "serial"}:
            raise AssertionError(f"[sidecar] {key}: answered by {by_tier}")
        compare_json(f"[sidecar] {key}", by_tier["serial"],
                     by_tier["batched"])
        n += 1
    log(f"[sidecar] {n} batched responses equal the serial service's")

    # the batched sims on the large lanes: no host read between lanes, one
    # fetch; K1 on a large lane's own filter and options inputs
    lanes = []
    for tid in large:
        tsi = svc._tenant(tid)
        _ng, ids, _r, _d, ng_dev = svc._ng_np(tsi, up)
        lanes.append(b.UpLane(nodes=tsi.dev_np["nodes"],
                              groups=tsi.dev_np["groups"],
                              pods=tsi.dev_np["pods"], ng=ng_dev, ids=ids))
    stacked = b.stack_up_lanes(lanes)
    nt, gt, pt, th = b.stack_down_lanes([
        b.DownLane(nodes=ln.nodes, groups=ln.groups, pods=ln.pods,
                   threshold=SIDE_THRESHOLD) for ln in lanes])
    torch.cuda.synchronize()
    hostfetch.reset_round_trips()
    t0 = time.perf_counter()
    with no_host_reads():
        out = scale_up_sim_batch(*stacked, dims, SIDE_MAX_NEW, "least-waste")
        fetch = hostfetch.fetch_pytree_async({
            "best": out.best, "pods": out.scores.pods,
            "fits": out.fits_existing.sum(-1, dtype=torch.int32)})
    host = fetch.get()
    up_batch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with no_host_reads():
        dn = scale_down_sim_batch(nt, gt, pt, th)
        fetch = hostfetch.fetch_pytree_async({"drainable":
                                              dn.removal.drainable})
    host_dn = fetch.get()
    down_batch_ms = (time.perf_counter() - t0) * 1e3
    if hostfetch.round_trips() != 2:
        raise AssertionError("[sidecar] the batched sims took more than one "
                             "fetch each")
    for i, tid in enumerate(large):
        resp = got[("churn", "up", tid)]["batched"]
        if resp["fits_existing"] != int(host["fits"][i]):
            raise AssertionError(f"[sidecar] direct batch differs for {tid}")
        valid = svc._tenant(tid).export_np["nodes"]["valid"].astype(bool)
        if (np.nonzero(host_dn["drainable"][i] & valid)[0].tolist()
                != got[("churn", "down", tid)]["batched"]["drainable"]):
            raise AssertionError(f"[sidecar] direct batch drain differs for "
                                 f"{tid}")
    log(f"[sidecar] scale_up_sim_batch over the {SIDE_LARGE} large lanes "
        f"{up_batch_ms} ms, scale_down_sim_batch {down_batch_ms} ms, each "
        f"one fetch, no host read inside ({card})")
    nt0 = b.node_tensors(lanes[0].nodes)
    gr0 = b.nodegroup_tensors(lanes[0].ng)
    gt0 = b.podgroup_tensors(lanes[0].groups)
    pt0 = b.sched_tensors(lanes[0].pods)
    filter_args = [x[None].contiguous() if i < 2 else x for i, x in
                   enumerate(filter_pack_inputs(nt0, gt0, pt0))]
    packed = schedule_pending_on_existing(nt0, gt0, pt0)
    remaining = torch.clamp(gt0.count - packed.scheduled, min=0)
    option_args, _ = option_pack_inputs(gt0.replace(count=remaining), gr0,
                                        dims, SIDE_MAX_NEW)
    err = max(check_pack("sidecar large-lane filter inputs", filter_args,
                         kernel, plain),
              check_pack("sidecar large-lane options inputs",
                         list(option_args), kernel, plain))
    times = {"filter": k1_times(filter_args, kernel, plain),
             "options": k1_times(list(option_args), kernel, plain)}
    for name, t in times.items():
        log(f"[sidecar] K1 on a large lane's {name} inputs: {k1_line(t)} "
            f"({card})")

    # WhatIf on one large tenant, against the port's whatif/ called directly
    body, rep, wi_ms = side_what_if(svc, large[1], LOOP_NODES, SIDE_WHATIF_T)
    direct = side_what_if_direct(svc, large[1], body)
    compare_json("[sidecar] WhatIf", side_strip(direct), rep)
    log(f"[sidecar] WhatIf on {large[1]}: {rep['lanes']} lanes (the null "
        f"lane and 4 variants, padded to {rung(rep['lanes'], 4)}), rollout "
        f"{SIDE_WHATIF_T} loops, "
        f"{wi_ms} ms; equal to whatif.multiverse_step and rollout_multiverse "
        f"called directly ({card})")

    # gRPC, where grpcio is installed; no device work depends on it
    try:
        import grpc  # noqa: F401
    except ImportError:
        log("[sidecar] grpc: not installed")
    else:
        from kubernetes_autoscaler_tpu_torch.sidecar.server import (
            SimulatorClient,
            make_grpc_server,
        )

        server, port = make_grpc_server(svc, port=0)
        server.start()
        try:
            params = {"max_new_nodes": SIDE_MAX_NEW,
                      "node_groups": side_node_groups()}
            for tid in large:
                r = SimulatorClient(port, tenant=tid).scale_up_sim(**params)
                compare_json(f"[sidecar] gRPC {tid}",
                             got[("churn", "up", tid)]["batched"], r)
            log(f"[sidecar] grpc: {len(large)} ScaleUpSim over "
                f"localhost equal the in-process answers")
        finally:
            server.stop(None)

    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    svc.close()
    ser.close()
    log(f"[sidecar] peak device memory allocated {peak_mib:.1f} MiB; phase "
        f"{time.perf_counter() - t_phase} s ({card})")
    return up_launches, up_launches / up_batches, err, times


def sidecar_cpu_card_phase(card):
    """Phase 19: 4 tenants of SIDE_CPU_CARD_NODES nodes in one class, the
    same script on the CPU and on the card: ScaleUpSim and ScaleDownSim
    batched, WhatIf with a rollout, and a constrained (KAUX) tenant's
    ScaleUpSim and ScaleDownSim on the serial tier. Ids, ints and bools
    equal, floats within rtol 1e-5, the chosen option the same. The shadow
    audit re-runs one lane of each window serially: no divergence."""
    from kubernetes_autoscaler_tpu_torch.sidecar.server import SimParams

    nodes = SIDE_CPU_CARD_NODES
    pods = LOOP_PODS * nodes // LOOP_NODES
    payload = side_payload(side_world_calls(nodes, pods))
    kaux = side_kaux_payload(16)
    up_p = {"max_new_nodes": SIDE_MAX_NEW, "node_groups": side_node_groups()}
    zone_ngs = [{"id": f"ng-{z}", "max_new": 8, "price": 1.0,
                 "template": {"name": f"tmpl-{z}", "labels": {ZONE_KEY: z},
                              "capacity": {"cpu": 4.0, "memory": 8 << 30,
                                           "pods": 110}}} for z in "ab"]
    tenants = [f"t{i}" for i in range(4)]
    runs = {}
    for device in ("cpu", DEVICE):
        (svc,) = side_services(device, (SIDE_LANES,), shadow_audit=True)
        for i, tid in enumerate(tenants):
            svc.apply_delta(payload, tenant=tid)
            svc.apply_delta(side_tenant_delta(i, f"x{i}"), tenant=tid)
        svc.apply_delta(kaux, tenant="kaux")
        r = {"up": side_round(svc, "scale_up_sim", SimParams(**up_p),
                              tenants),
             "down": side_round(svc, "scale_down_sim",
                                SimParams(threshold=SIDE_THRESHOLD), tenants),
             "kaux": side_round(svc, "scale_up_sim", SimParams(
                 max_new_nodes=8, node_groups=zone_ngs), ["kaux"]),
             "kaux-down": side_round(svc, "scale_down_sim", SimParams(
                 threshold=0.6), ["kaux"])}
        _b, r["whatif"], _ms = side_what_if(svc, tenants[0], nodes,
                                            SIDE_WHATIF_T)
        if not svc.audit_quiesce() or svc.audit_stats()["divergences"]:
            raise AssertionError(f"[sidecar-cpu-card] shadow audit on "
                                 f"{device}: {svc.audit_stats()}")
        r["audit"] = svc.audit_stats()["checks"]
        if svc._batchable(svc._tenant("kaux")):
            raise AssertionError("[sidecar-cpu-card] the KAUX tenant batched")
        runs[device] = r
        svc.close()
    near = 0
    for kind in ("up", "down"):
        for tid in tenants:
            near += compare_json(f"[sidecar-cpu-card] {kind} {tid}",
                                 runs["cpu"][kind][tid][0],
                                 runs[DEVICE][kind][tid][0], rtol=1e-5)
    for kind in ("kaux", "kaux-down"):
        near += compare_json(f"[sidecar-cpu-card] {kind}",
                             runs["cpu"][kind]["kaux"][0],
                             runs[DEVICE][kind]["kaux"][0], rtol=1e-5)
    near += compare_json("[sidecar-cpu-card] WhatIf", runs["cpu"]["whatif"],
                         runs[DEVICE]["whatif"], rtol=1e-5)
    log(f"[sidecar-cpu-card] {len(tenants)} tenants of {nodes} nodes and a "
        f"KAUX tenant of 16: ScaleUpSim, ScaleDownSim and WhatIf equal on the "
        f"CPU and the card (ids, ints, bools and chosen options exact; {near} "
        f"floats differ within rtol 1e-5); shadow audit checks on the card "
        f"{json.dumps(runs[DEVICE]['audit'])}, no divergence ({card})")


# ---------------------------------------------------------------- the VPA

# The upstream recommender's documented defaults (vertical-pod-autoscaler,
# pkg/recommender/main.go: --recommender-interval=1m, --history-length=8d,
# --history-resolution=1h) with histogram.py's 24 h half-lives, on a cluster
# of VPA_OBJECTS VPA objects, each targeting a workload of VPA_PODS pods with
# the containers VPA_CONTAINERS: 50,000 pods, 100,000 containers, 20,000
# aggregates.
VPA_OBJECTS = 10_000
VPA_PODS = 5
VPA_CONTAINERS = ("app", "sidecar")
VPA_SIDECAR_SHARE = 0.25      # a sidecar's usage as a share of its app's
VPA_HISTORY_POINTS = 192      # --history-length=8d at --history-resolution=1h
VPA_HISTORY_STEP_S = 3600.0
VPA_INTERVAL_S = 60.0         # --recommender-interval=1m
VPA_STEPS = 10                # timed RunOnce steps
VPA_OOM_SHARE = 0.01          # a step's samples marked OOM
VPA_SEED = 0
VPA_NOW = 1_700_000_000.0     # the history's end, in epoch seconds
VPA_LIMIT_MS = 6000.0         # RunOnce p90: a tenth of the 1 min interval


class VpaScript:
    """The [vpa] cluster, made from `seed`: each workload has a CPU and a
    memory level, log-uniform in [0.05, 4] cores and [64 MiB, 8 GiB] (its
    sidecar at VPA_SIDECAR_SHARE of them), times a log-normal noise pattern
    per (time, pod slot, container) that every workload shares, so that the
    target is monotone in the level by construction; VPA_OOM_SHARE of each
    step's samples are OOMs. The step samples, the VPAs and the pods are
    built once and fed to every run."""

    def __init__(self, n_objects=VPA_OBJECTS, steps=VPA_STEPS, seed=VPA_SEED):
        from kubernetes_autoscaler_tpu_torch.vpa import model, updater

        rng = np.random.default_rng(seed)
        self.n, self.steps = n_objects, steps
        share = np.asarray([1.0, VPA_SIDECAR_SHARE])
        self.cpu = np.exp(rng.uniform(np.log(0.05), np.log(4.0),
                                      n_objects))[:, None] * share
        self.mem = np.exp(rng.uniform(np.log(64 * 2**20), np.log(8 * 2**30),
                                      n_objects))[:, None] * share
        self.hist_cpu = rng.lognormal(0, 0.3, (VPA_HISTORY_POINTS, 2))
        self.hist_mem = rng.lognormal(0, 0.2, (VPA_HISTORY_POINTS, 2))
        step_cpu = rng.lognormal(0, 0.3, (steps, VPA_PODS, 2))
        step_mem = rng.lognormal(0, 0.2, (steps, VPA_PODS, 2))
        self.oom = rng.random((steps, n_objects, VPA_PODS, 2)) < VPA_OOM_SHARE
        self.samples = []
        for k in range(steps):
            now = self.now(k)
            cpu = (self.cpu[:, None, :] * step_cpu[k][None]).tolist()
            mem = (self.mem[:, None, :] * step_mem[k][None]).tolist()
            oom = self.oom[k].tolist()
            self.samples.append([model.ContainerUsageSample(
                namespace="default", pod_name=f"w{w}-{p}",
                container_name=c, owner_name=f"w{w}",
                cpu_cores=cpu[w][p][i], memory_bytes=mem[w][p][i],
                is_oom=oom[w][p][i], timestamp=now)
                for w in range(n_objects) for p in range(VPA_PODS)
                for i, c in enumerate(VPA_CONTAINERS)])
        self.targets = {f"w{w}": list(VPA_CONTAINERS) for w in range(n_objects)}
        req = rng.lognormal(0, 0.5, (n_objects, VPA_PODS, 2)).tolist()
        self.pods = [updater.PodView(
            name=f"w{w}-{p}", namespace="default", owner_name=f"w{w}",
            containers={c: {"cpu": float(self.cpu[w, i] * req[w][p][i]),
                            "memory": float(self.mem[w, i] * req[w][p][i])}
                        for i, c in enumerate(VPA_CONTAINERS)},
            start_time=VPA_NOW - 86400.0, replicas_of_owner=VPA_PODS)
            for w in range(n_objects) for p in range(VPA_PODS)]

    @staticmethod
    def now(k: int) -> float:
        return VPA_NOW + VPA_INTERVAL_S * (k + 1)

    def vpas(self):
        from kubernetes_autoscaler_tpu_torch.vpa import model

        return [model.VerticalPodAutoscaler(name=f"v{w}", target_name=f"w{w}")
                for w in range(self.n)]

    def query_fn(self):
        """A Prometheus stand-in answering the provider's two range queries:
        one series per aggregate (its workload's first pod), hourly points
        over the last 8 days. Built before the clock starts."""
        ts = (VPA_NOW - VPA_HISTORY_STEP_S
              * np.arange(VPA_HISTORY_POINTS)[::-1]).tolist()
        answers = {}
        for resource, level, noise in (("cpu", self.cpu, self.hist_cpu),
                                       ("memory", self.mem, self.hist_mem)):
            answers[resource] = [
                {"metric": {"namespace": "default", "pod": f"w{w}-0",
                            "container": c},
                 "values": list(zip(ts, (level[w, i] * noise[:, i]).tolist()))}
                for w in range(self.n) for i, c in enumerate(VPA_CONTAINERS)]

        def query(q, start, end):
            return answers["cpu" if "cpu" in q else "memory"]

        return query


class VpaClock:
    """Per-instance wrappers around a recommender's two banks: the host
    time (each call ended by a synchronize) of the decays, the scatters and
    the percentiles, and the device-to-host reads made by the percentiles."""

    def __init__(self, rec, sync):
        from kubernetes_autoscaler_tpu_torch.vpa import histogram

        self.ms = {"decay": 0.0, "scatter": 0.0, "percentiles": 0.0}
        self.fetches = 0
        self._hist = histogram
        self._to_host = histogram.to_host
        for bank in (rec.cpu, rec.memory):
            for meth, key in (("decay_to", "decay"), ("add_samples", "scatter"),
                              ("percentile", "percentiles")):
                setattr(bank, meth, self._timed(getattr(bank, meth), key, sync))

    def _timed(self, fn, key, sync):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            self.ms[key] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    def __enter__(self):
        def counted(x, dtype=None):
            self.fetches += 1
            return self._to_host(x, dtype)
        self._hist.to_host = counted
        return self

    def __exit__(self, *exc):
        self._hist.to_host = self._to_host

    def take(self) -> dict:
        out = dict(self.ms, fetches=self.fetches)
        self.ms = dict.fromkeys(self.ms, 0.0)
        self.fetches = 0
        return out


def vpa_snapshot(rec):
    return tuple(getattr(getattr(rec, b), f).clone()
                 for b in ("cpu", "memory") for f in ("weights", "total"))


def vpa_recs(vpas):
    import dataclasses

    return [[dataclasses.asdict(r) for r in v.recommendation] for v in vpas]


def vpa_run(device, script, capture=None):
    """The [vpa] script on `device`: the history through the Prometheus
    provider, `script.steps` RunOnce steps (feed, recommend), the updater
    over every pod, a checkpoint saved and loaded. Returns its times,
    counts, the banks after the history and after every step, every step's
    recommendations, the updater's decisions and the checkpoint's path.
    With `capture`, the scatter's inputs of its first call (the history's
    CPU bank, moved to the host once the history is timed) and of the last
    step's memory bank go there, for [kernels]: two device clones of a bank
    in the timed run, no other scatter wrapped in more than a check."""
    from kubernetes_autoscaler_tpu_torch.vpa import (
        checkpoint,
        histogram,
        history,
        recommender,
        updater,
    )

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    scatter = histogram.scatter_add_ordered
    last_step = []          # set just before the last step
    if capture is not None:
        def capturing(weights, total, agg, bucket, w):
            if not capture or (last_step and weights is rec.memory.weights):
                capture.append([weights.clone(), total.clone(), agg, bucket,
                                w])
            return scatter(weights, total, agg, bucket, w)
        histogram.scatter_add_ordered = capturing
    out = {"snap": [], "recs": []}
    try:
        rec = recommender.Recommender(device=device)
        clock = VpaClock(rec, sync)
        query = script.query_fn()
        prov = history.PrometheusHistoryProvider(
            query_fn=query, pod_owner=lambda ns, pod: pod.rsplit("-", 1)[0])
        with clock:
            t0 = time.perf_counter()
            n = prov.load_into(rec, now=VPA_NOW)
            sync()
            out["history_ms"] = (time.perf_counter() - t0) * 1e3
            out["history"] = clock.take()
            out["history_samples"] = n
            if capture:
                capture[0] = [a.cpu() for a in capture[0]]
            out["snap"].append(vpa_snapshot(rec))
            vpas = script.vpas()
            out["steps"] = []
            for k in range(script.steps):
                now = script.now(k)
                if k == script.steps - 1:
                    last_step.append(True)
                t0 = time.perf_counter()
                rec.feed(script.samples[k], now=now)
                sync()
                t1 = time.perf_counter()
                rec.recommend(vpas, script.targets, now=now)
                t2 = time.perf_counter()
                st = clock.take()
                st.update(feed=(t1 - t0) * 1e3, recommend=(t2 - t1) * 1e3,
                          run_once=(t2 - t0) * 1e3)
                out["steps"].append(st)
                out["snap"].append(vpa_snapshot(rec))
                out["recs"].append(vpa_recs(vpas))
        evicted = []
        upd = updater.Updater(evict=lambda p: evicted.append(p.name))
        t0 = time.perf_counter()
        acted = upd.run_once(vpas, script.pods, now=script.now(script.steps))
        out["updater_ms"] = (time.perf_counter() - t0) * 1e3
        out["decisions"] = [(d.pod.name, d.priority, d.outside_bounds,
                             d.in_place) for d in acted]
        out["evicted"] = evicted
        out["dir"] = tempfile.mkdtemp(prefix="vpa-ckpt-")
        out["ckpt"] = os.path.join(out["dir"], "checkpoint.npz")
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(rec, out["ckpt"], script.now(script.steps))
        out["save_ms"] = (time.perf_counter() - t0) * 1e3
        out["ckpt_bytes"] = os.path.getsize(out["ckpt"])
        t0 = time.perf_counter()
        loaded = checkpoint.load_checkpoint(out["ckpt"], device=device)
        sync()
        out["load_ms"] = (time.perf_counter() - t0) * 1e3
        if loaded._index != rec._index or not all(
                torch.equal(a, b) for a, b in zip(vpa_snapshot(loaded),
                                                   vpa_snapshot(rec))):
            raise AssertionError(f"[vpa] the checkpoint round trip on "
                                 f"{device} is not byte-equal")
        out["rec"], out["vpas"] = rec, vpas
    finally:
        histogram.scatter_add_ordered = scatter
    return out


def vpa_monotone(script, vpas):
    """Each container's target against its workload's level. The workloads
    share one noise pattern, so a workload of lower level has every sample
    at most its counterpart's: the CPU target, and the memory target among
    workloads that had no OOM, are monotone in the level. An OOM sample is
    bumped by OOM_BUMP_RATIO, so over every workload a memory target is at
    most OOM_BUMP_RATIO times one bucket's ratio (the rounding to a bucket
    end) the target of any workload of higher level. Returns the pairs that
    break either."""
    from kubernetes_autoscaler_tpu_torch.vpa import histogram, recommender

    slack = recommender.OOM_BUMP_RATIO * histogram.MEMORY_SCHEME.ratio
    bad = []
    for i, c in enumerate(VPA_CONTAINERS):
        no_oom = ~script.oom[..., i].any(axis=(0, 2))
        for res, level in (("cpu", script.cpu[:, i]),
                           ("memory", script.mem[:, i])):
            order = np.argsort(level, kind="stable")
            got = np.asarray([next(r.target[res]
                                   for r in vpas[w].recommendation
                                   if r.container_name == c) for w in order])
            keep = no_oom[order] if res == "memory" else np.ones(len(got), bool)
            w_k, g_k = order[keep], got[keep]
            bad += [(c, res, int(w_k[j]), g_k[j], g_k[j + 1])
                    for j in range(len(g_k) - 1) if g_k[j + 1] < g_k[j]]
            if res == "memory":
                # the least target over each workload's higher levels
                above = np.minimum.accumulate(got[::-1])[::-1][1:]
                bad += [(c, "memory with OOMs", int(order[j]), got[j],
                         slack * above[j])
                        for j in np.flatnonzero(got[:-1] > slack * above)]
    return bad


def hist_bound(args) -> tuple[float, str]:
    """(bound ms, 'bytes') of one scatter on these inputs: each sample read
    once (aggregate, bucket, weight: 12 B) and each touched bin and total
    read and written once (8 B each); the adds (two a sample) are far below
    the card's rate."""
    weights, _total, agg, bucket, w = args
    flat = agg.long() * weights.shape[1] + bucket.long()
    touched = int(torch.unique(flat).numel()) + int(torch.unique(agg).numel())
    t_bytes = (agg.numel() * 12 + touched * 8) / H100_BYTES_PER_S * 1e3
    t_ops = 2 * agg.numel() / H100_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_hist(name, args, kernel, plain) -> float:
    """The scatter kernel on card copies of `args` against the plain version
    on CPU copies: every bin and total byte-equal. Returns the max abs
    difference."""
    cpu = [a.detach().cpu().clone() for a in args]
    dev = [a.detach().to(DEVICE).clone() for a in args]
    plain(*cpu)
    kernel(*dev)
    torch.cuda.synchronize()
    err = 0.0
    for i, field in ((0, "weights"), (1, "total")):
        got = dev[i].cpu()
        err = max(err, float((got.double() - cpu[i].double()).abs().max()))
        if got.numpy().tobytes() != cpu[i].numpy().tobytes():
            raise AssertionError(f"{name}: {field} differs from the plain "
                                 f"version (max abs {err})")
    log(f"[kernels] scatter_add_ordered == plain: {name} (A="
        f"{args[0].shape[0]} B={args[0].shape[1]} n={args[2].numel()})")
    return err


def hist_times(args, kernel, plain) -> dict:
    """The scatter's times on `args`: the wrapper as launched from Python
    (its checks, the workspace and the one C call), the device time of
    every pass (the stream held while the host enqueues), the ordering
    passes' alone (the entry's `order_only`), the plain version's on the
    CPU (host clock), and the library call on the card: `index_add_` on
    the bins and on the totals, atomic, whose order of summation is not
    fixed."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import histogram_kernel

    weights, total, agg, bucket, w = [a.to(DEVICE).clone() for a in args]
    flat = agg.long() * weights.shape[1] + bucket.long()
    agg_l = agg.long()

    def scatter():
        kernel(weights, total, agg, bucket, w)

    t = {"launch": cuda_ms(scatter, REPS),
         "device": cuda_ms(scatter, REPS, hold=True),
         "order": cuda_ms(lambda: histogram_kernel.launch(
             weights, total, agg, bucket, w, order_only=True), REPS,
             hold=True),
         "library": cuda_ms(lambda: (weights.view(-1).index_add_(0, flat, w),
                                     total.index_add_(0, agg_l, w)), REPS)}
    cpu = [a.cpu().clone() for a in args]
    plain_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        plain(*cpu)
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    t["plain"] = statistics.median(plain_ms)
    t["bound"], t["bound_by"] = hist_bound(args)
    return t


def hist_line(name, args, t) -> str:
    return (f"[kernels] scatter_add_ordered {name} A={args[0].shape[0]} "
            f"n={args[2].numel()}: {t['launch']} ms as launched from Python, "
            f"{t['device']} ms of device time (every pass), of which the "
            f"ordering passes {t['order']} ms; plain (CPU index_add_) "
            f"{t['plain']} ms, library (atomic index_add_ on the card) "
            f"{t['library']} ms, bound {t['bound']} ms ({t['bound_by']})")


def plain_route_probe(args) -> str:
    """Whether a plain route on the card sums in sample order: a stable
    sort of the flat bin index followed by `index_put_(accumulate=True)`
    (sort-based on CUDA), and the atomic `index_add_`, each against the
    CPU's order on the same inputs. Returns a line for the log."""
    weights, total, agg, bucket, w = args
    want = weights.cpu().clone()
    want.view(-1).index_add_(0, agg.cpu().long() * want.shape[1]
                             + bucket.cpu().long(), w.cpu())
    flat = (agg.long() * weights.shape[1] + bucket.long()).to(DEVICE)
    out = []
    for route in ("sort + index_put_(accumulate=True)", "index_add_"):
        got = weights.to(DEVICE).clone()
        if route == "index_add_":
            got.view(-1).index_add_(0, flat, w.to(DEVICE))
        else:
            keys, perm = torch.sort(flat, stable=True)
            got.view(-1).index_put_((keys,), w.to(DEVICE)[perm],
                                    accumulate=True)
        diff = int((got.cpu().view(torch.int32)
                    != want.view(torch.int32)).sum())
        out.append(f"{route}: {diff} of {want.numel()} bins differ")
    return "; ".join(out)


def vpa_phase(card, kernel, plain):
    """Phase 20: the recommender at a large cluster's scale on the card.
    Returns (the card run, the scatter's launches on the path, its kernels
    line fields, its max abs err)."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels import histogram_kernel

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    script = VpaScript(VPA_OBJECTS, VPA_STEPS)
    log(f"[vpa] cluster: {script.n} VPA objects, {script.n * VPA_PODS} pods, "
        f"{script.n * VPA_PODS * len(VPA_CONTAINERS)} containers, "
        f"{script.n * len(VPA_CONTAINERS)} aggregates; history "
        f"{VPA_HISTORY_POINTS} points an aggregate at "
        f"{VPA_HISTORY_STEP_S:g} s; {script.steps} RunOnce steps "
        f"{VPA_INTERVAL_S:g} s apart (script built in "
        f"{time.perf_counter() - t0:.1f} s)")
    # what the process carries into the phase's host loops
    log(f"[vpa] process: {threading.active_count()} threads, "
        f"{len(gc.get_objects())} objects the collector tracks")
    torch.cuda.reset_peak_memory_stats()
    capture = []
    histogram_kernel.scatter_add_ordered.launches = 0
    run = vpa_run(DEVICE, script, capture)
    launches = histogram_kernel.scatter_add_ordered.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    h = run["history"]
    log(f"[vpa] history: {run['history_samples']} samples through "
        f"PrometheusHistoryProvider -> feed_history in {run['history_ms']} ms: "
        f"device (bucket lookup and scatter, synchronized) {h['scatter']} ms, "
        f"decay {h['decay']} ms, host "
        f"{run['history_ms'] - h['scatter'] - h['decay']} ms")
    steps = run["steps"]
    ro = [s["run_once"] for s in steps]
    rows = {"decay": [s["decay"] for s in steps],
            "feed host loop": [s["feed"] - s["decay"] - s["scatter"]
                               for s in steps],
            "feed device scatter": [s["scatter"] for s in steps],
            "recommend percentiles": [s["percentiles"] for s in steps],
            "recommend host assembly": [s["recommend"] - s["percentiles"]
                                        for s in steps]}
    log(f"[vpa] RunOnce ms over {len(ro)} steps (feed of "
        f"{len(script.samples[0])} samples, recommend of {script.n} VPAs): "
        f"p50 {pct(ro, 50)} p90 {pct(ro, 90)}; limit p90 <= {VPA_LIMIT_MS:g} "
        f"ms {'met' if pct(ro, 90) <= VPA_LIMIT_MS else 'NOT met'}")
    for name, xs in rows.items():
        log(f"[vpa] RunOnce {name} ms: p50 {pct(xs, 50)} p90 {pct(xs, 90)}")
    fetches = sorted({s["fetches"] for s in steps})
    log(f"[vpa] fetches per RunOnce: {fetches}; scatter launches on the path "
        f"{launches} (history and {len(steps)} steps, 2 banks each)")
    log(f"[vpa] updater over {len(script.pods)} pods: {run['updater_ms']} ms, "
        f"{len(run['evicted'])} evictions of {len(run['decisions'])} acted "
        f"decisions")
    log(f"[vpa] checkpoint: {run['ckpt_bytes']} bytes, save {run['save_ms']} "
        f"ms, load {run['load_ms']} ms, round trip byte-equal")
    log(f"[vpa] peak device memory allocated: {peak_mib:.1f} MiB ({card})")
    if launches != 2 * (1 + len(steps)):
        raise AssertionError(f"[vpa] expected {2 * (1 + len(steps))} scatter "
                             f"launches, got {launches}")
    if fetches != [6]:
        raise AssertionError(f"[vpa] fetches per RunOnce {fetches}, expected 6")
    missing = [v.name for v in run["vpas"]
               if len(v.recommendation) != len(VPA_CONTAINERS)]
    if missing:
        raise AssertionError(f"[vpa] {len(missing)} VPAs without a full "
                             f"recommendation, e.g. {missing[:3]}")
    bad = vpa_monotone(script, run["vpas"])
    if bad:
        raise AssertionError(f"[vpa] the target is not monotone in usage: "
                             f"{len(bad)} pairs, e.g. {bad[:3]}")
    ends = {res: [run["vpas"][int(f(level[:, 0]))].recommendation[0]
                  .target[res] for f in (np.argmin, np.argmax)]
            for res, level in (("cpu", script.cpu), ("memory", script.mem))}
    oom = int(script.oom.any(axis=(0, 2, 3)).sum())
    log(f"[vpa] every VPA recommended; targets monotone in usage, the memory "
        f"targets of the {oom} workloads with an OOM within the OOM bump and "
        f"one bucket of every higher level's (app target of the least and "
        f"the most used workload: cpu {ends['cpu'][0]} .. {ends['cpu'][1]} "
        f"cores, memory {ends['memory'][0]} .. {ends['memory'][1]} B)")

    # the scatter kernel on the inputs the path gave it, and its times there
    err = 0.0
    names = ("history cpu bank", "RunOnce memory bank")
    entry = {}
    for name, args in zip(names, capture):
        err = max(err, check_hist(f"vpa-path {name} inputs", args, kernel,
                                  plain))
        dev = [a.to(DEVICE).clone() for a in args]
        torch.cuda.synchronize()
        with no_host_reads():
            kernel(*dev)
        torch.cuda.synchronize()
        log(f"[vpa] scatter_add_ordered on the {name} inputs under "
            f"torch.cuda sync debug mode 'error': no host read")
        t = hist_times(args, kernel, plain)
        log(hist_line(name, args, t))
        entry[name] = t
    log(f"[kernels] plain routes on the card at the history's width: "
        f"{plain_route_probe(capture[0])}")
    del capture
    t, h = entry[names[1]], entry[names[0]]
    fields = {"ms": t["launch"], "device_ms": t["device"],
              "order_ms": t["order"], "order_share": t["order"] / t["device"],
              "plain_ms": t["plain"], "bound_ms": t["bound"],
              "bound_by": t["bound_by"], "library_ms": t["library"],
              "history_ms": h["launch"], "history_device_ms": h["device"],
              "history_order_ms": h["order"],
              "history_order_share": h["order"] / h["device"],
              "history_library_ms": h["library"],
              "history_bound_ms": h["bound"]}
    log(f"[vpa] phase took {time.perf_counter() - t_phase:.1f} s")
    run["script"] = script
    return run, launches, fields, err


def vpa_cpu_card_phase(card, card_run):
    """Phase 21: [vpa]'s script on the CPU against [vpa]'s card run: both
    banks' weights and totals byte-equal after the history and after every
    RunOnce, every recommendation equal (floats exactly), the updater's
    decisions equal, and each side's checkpoint loads on the other with its
    arrays byte-equal."""
    from kubernetes_autoscaler_tpu_torch.ops.hostfetch import to_host
    from kubernetes_autoscaler_tpu_torch.vpa import checkpoint

    t0 = time.perf_counter()
    script = card_run["script"]
    cpu_run = vpa_run("cpu", script)
    for i, (c, g) in enumerate(zip(cpu_run["snap"], card_run["snap"])):
        for j, (a, b) in enumerate(zip(c, g)):
            if a.numpy().tobytes() != to_host(b).tobytes():
                when = "the history" if i == 0 else f"step {i}"
                raise AssertionError(f"[vpa-cpu-card] bank array {j} differs "
                                     f"after {when}")
    for k, (a, b) in enumerate(zip(cpu_run["recs"], card_run["recs"])):
        if a != b:
            raise AssertionError(f"[vpa-cpu-card] recommendations differ at "
                                 f"step {k}")
    if cpu_run["decisions"] != card_run["decisions"]:
        raise AssertionError("[vpa-cpu-card] the updater's decisions differ")
    for path, device, want in ((card_run["ckpt"], "cpu", cpu_run["rec"]),
                               (cpu_run["ckpt"], DEVICE, card_run["rec"])):
        loaded = checkpoint.load_checkpoint(path, device=device)
        if loaded._index != want._index or not all(
                to_host(a).tobytes() == to_host(b).tobytes()
                for a, b in zip(vpa_snapshot(loaded), vpa_snapshot(want))):
            raise AssertionError(f"[vpa-cpu-card] the checkpoint {path} does "
                                 f"not load on {device} byte-equal")
    for run in (cpu_run, card_run):
        shutil.rmtree(run["dir"], ignore_errors=True)
    n_recs = sum(len(r) for step in cpu_run["recs"] for r in step)
    log(f"[vpa-cpu-card] {len(cpu_run['snap'])} bank snapshots byte-equal "
        f"(after the history and {len(cpu_run['steps'])} steps), {n_recs} "
        f"recommendations equal, {len(cpu_run['decisions'])} updater "
        f"decisions equal, checkpoints load across byte-equal; the CPU run "
        f"(RunOnce p50 {pct([s['run_once'] for s in cpu_run['steps']], 50)} "
        f"ms) and the comparison took {time.perf_counter() - t0:.1f} s "
        f"({card})")


# ---------------------------------------------------------------- mesh

MESH_LOOPS = 4            # loops of the mesh-armed control loop and its twin


def mesh_loop(mesh, loops):
    """The churn script on [loop]'s world with `mesh` (None: none) on the
    orchestrator: (per-loop decision surfaces, loops deferred with cause
    mesh-sharded)."""
    fake = loop_world(LOOP_NODES, LOOP_PODS)
    a = loop_autoscaler(fake, DEVICE, capture_verdicts=True)
    a.scale_up_orchestrator.mesh = mesh
    script = LoopScript(fake, LOOP_NODES, LOOP_PODS)
    rows = []
    for loop in range(loops):
        script.before(loop)
        rows.append(loop_surfaces(a, a.run_once(now=1000.0 + 10.0 * loop)))
        script.after(loop)
    return rows, a.metrics.counter("fused_deferrals_total").value(
        cause="mesh-sharded")


MESH_GLOO_RANKS = 2       # processes of [mesh]'s gloo group on the one card
MESH_GLOO_TIMEOUT_S = 300


def mesh_sharded_calls(mesh, dims, world) -> dict:
    """The sharded calls of dryrun_multichip at `world` on `mesh`, each held
    to its unsharded call: `scale_up_sim` (ints exact, floats within rtol
    1e-5, the same best option; its K1 launches counted),
    pack_groups_sharded against the filter pack, the option-sharded
    estimate (ints and bools only, so byte-equal).
    Returns the launches and each call's host-clock ms (synchronized, the
    second of two runs)."""
    from kubernetes_autoscaler_tpu_torch.ops import autoscale_step, binpack, pack
    from kubernetes_autoscaler_tpu_torch.ops.kernels import pack_kernel
    from kubernetes_autoscaler_tpu_torch.ops.schedule import filter_pack_inputs

    enc, groups = world

    def ms(fn):
        fn()                                   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def sim(m):
        return autoscale_step.scale_up_sim(
            enc.nodes, enc.specs, enc.scheduled, groups, dims, MAX_NEW_NODES,
            "least-waste", mesh=m)

    def estimate(m):
        return binpack.estimate_all(rest, groups, dims, MAX_NEW_NODES, mesh=m)

    pack_kernel.pack_groups_batched.launches = 0
    up_mesh = sim(mesh)
    torch.cuda.synchronize()
    out = {"launches": pack_kernel.pack_groups_batched.launches}
    up = sim(None)
    compare_cpu_card("[mesh] scale_up_sim", up, up_mesh)
    if int(up.best) != int(up_mesh.best):
        raise AssertionError("[mesh] scale_up_sim chose another option")
    args = filter_pack_inputs(enc.nodes, enc.specs, enc.scheduled)
    check_equal("[mesh] pack_groups_sharded",
                pack.pack_groups_sharded(mesh, *args), pack.pack_groups(*args))
    rest = enc.specs.replace(count=up.remaining)
    compare_cpu_card("[mesh] estimate_all", estimate(None), estimate(mesh))
    out.update(scale_up_sim_mesh_ms=ms(lambda: sim(mesh)),
               scale_up_sim_ms=ms(lambda: sim(None)),
               sharded_pack_ms=ms(lambda: pack.pack_groups_sharded(mesh,
                                                                   *args)),
               filter_pack_ms=ms(lambda: pack.pack_groups(*args)),
               sharded_estimate_ms=ms(lambda: estimate(mesh)),
               estimate_ms=ms(lambda: estimate(None)))
    out["best"] = int(up.best)
    return out


def mesh_rank_main(rank: int, workdir: str) -> int:
    """One rank of [mesh]'s two-process gloo group on the one card: the
    world of [main], then `mesh_sharded_calls` on the meshes (1, 2) and
    (2, 1). NCCL admits one rank a GPU; gloo carries CUDA tensors through
    the host (checked on the H100 machine), so two processes can share the
    card. Prints one JSON line."""
    import datetime

    import torch.distributed as dist

    from kubernetes_autoscaler_tpu_torch.models.cluster_state import Dims
    from kubernetes_autoscaler_tpu_torch.parallel import mesh as pmesh

    dist.init_process_group(
        "gloo", init_method=f"file://{workdir}/rendezvous",
        world_size=MESH_GLOO_RANKS, rank=rank,
        timeout=datetime.timedelta(seconds=MESH_GLOO_TIMEOUT_S))
    try:
        world = build_world(NODES, PODS, POD_GROUPS, NODEGROUPS,
                            RESIDENTS_PER_NODE, DEVICE)
        out = {"rank": rank}
        for npar in (MESH_GLOO_RANKS, 1):
            m = pmesh.make_mesh(nodes_parallel=npar, device=DEVICE)
            out[str(tuple(m.shape))] = mesh_sharded_calls(m, Dims(), world)
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def mesh_gloo_run(card) -> int:
    """[mesh]'s two-rank run: MESH_GLOO_RANKS processes of this script on
    the one card; every rank's checks passed and its K1 launches. Returns
    the K1 launches of the ranks' `scale_up_sim` calls with the mesh."""
    workdir = tempfile.mkdtemp(prefix="ka_mesh_gloo_")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
         "--mesh-dir", workdir], stdout=subprocess.PIPE, text=True)
        for r in range(MESH_GLOO_RANKS)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=MESH_GLOO_TIMEOUT_S)
            if p.returncode != 0:
                raise AssertionError(f"[mesh] gloo rank {r} exited "
                                     f"{p.returncode}: {out[-2000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    launches = 0
    for o in outs:
        for shape, t in o.items():
            if shape == "rank":
                continue
            launches += t["launches"]
            if t["launches"] < 1 or t["best"] != outs[0][shape]["best"]:
                raise AssertionError(f"[mesh] gloo rank {o['rank']} mesh "
                                     f"{shape}: {t}")
            log(f"[mesh] gloo rank {o['rank']} of {MESH_GLOO_RANKS} on the "
                f"one card, mesh (pods, nodes) {shape}: every sharded call "
                f"equal to its unsharded call, best option {t['best']}, K1 "
                f"launches {t['launches']}; host ms (synchronized, the second "
                f"run of each): scale_up_sim {t['scale_up_sim_mesh_ms']} with the "
                f"mesh vs {t['scale_up_sim_ms']}, pack_groups_sharded "
                f"{t['sharded_pack_ms']} vs K1's filter pack "
                f"{t['filter_pack_ms']}, estimate_all {t['sharded_estimate_ms']}"
                f" vs {t['estimate_ms']} ({card})")
    return launches


def mesh_phase(card, dims, world):
    """Phase 22: the device mesh at [main]'s world, on a one-rank NCCL
    group in this process, then on a two-rank gloo group of two processes
    (mesh_gloo_run). Returns (K1 launches on the path, the two-rank run's
    K1 launches, K1's times on one rank's option slice); the sharded
    pack's and estimate's times are logged only: they are not kernels of
    their own."""
    import torch.distributed as dist

    from kubernetes_autoscaler_tpu_torch.ops import binpack, pack
    from kubernetes_autoscaler_tpu_torch.ops.kernels import pack_kernel
    from kubernetes_autoscaler_tpu_torch.ops.schedule import filter_pack_inputs
    from kubernetes_autoscaler_tpu_torch.parallel import mesh as pmesh
    from kubernetes_autoscaler_tpu_torch.parallel import multihost

    t_phase = time.perf_counter()
    enc, groups = world
    rdv = tempfile.mkdtemp(prefix="ka_mesh_")
    if not multihost.initialize(f"file://{rdv}/rendezvous", 1, 0,
                                device=DEVICE):
        raise AssertionError("[mesh] no process group was joined")
    try:
        m = pmesh.make_mesh(device=DEVICE)
        log(f"[mesh] process group: backend {dist.get_backend()}, "
            f"{dist.get_world_size()} rank; mesh "
            f"{dict(zip(m.mesh_dim_names, m.shape))} over the world of "
            f"[main]: {describe(enc, groups)}")
        # the path: scale_up_sim with the mesh (each sharded call held to
        # its unsharded one), then the mesh-armed loop
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        calls = mesh_sharded_calls(m, dims, world)
        pack_kernel.pack_groups_batched.launches = 0
        rows, deferred = mesh_loop(m, MESH_LOOPS)
        loop_launches = pack_kernel.pack_groups_batched.launches
        launches = calls["launches"] + loop_launches
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        log(f"[mesh] scale_up_sim with the mesh == without (ints exact, "
            f"floats within rtol 1e-5, best option {calls['best']}), "
            f"pack_groups_sharded == K1's filter pack, estimate_all with the "
            f"mesh == without (byte-equal); K1 launches: scale_up_sim with "
            f"the mesh {calls['launches']}, the mesh-armed loop "
            f"{loop_launches} in {MESH_LOOPS} loops at {LOOP_NODES} "
            f"nodes; peak device memory allocated {peak_mib:.1f} MiB ({card})")
        if calls["launches"] < 1 or loop_launches < 1:
            raise AssertionError("[mesh] K1 was not launched on the path")
        plain_rows, plain_deferred = mesh_loop(None, MESH_LOOPS)
        if deferred != MESH_LOOPS or plain_deferred:
            raise AssertionError(f"[mesh] deferrals {deferred} with the "
                                 f"mesh, {plain_deferred} without")
        for loop, (a, b) in enumerate(zip(rows, plain_rows)):
            if a["fused_mode"] != "phased" or a["digests"] != b["digests"]:
                raise AssertionError(f"[mesh] loop {loop}: {a} with the mesh"
                                     f", {b} without")
            log(f"[mesh] loop {loop}: fused_mode {a['fused_mode']} (without "
                f"the mesh {b['fused_mode']}), deferred as mesh-sharded, "
                f"decision digests equal ("
                f"{', '.join(f'{k} {v}' for k, v in a['digests'].items())})")
        # times of the sharded calls beside the unsharded ones
        args = filter_pack_inputs(enc.nodes, enc.specs, enc.scheduled)
        rest = enc.specs.replace(count=torch.clamp(
            enc.specs.count - pack.pack_groups(*args).scheduled, min=0))

        def estimate(mesh):
            return binpack.estimate_all(rest, groups, dims, MAX_NEW_NODES,
                                        mesh=mesh)

        t = {"sharded_pack": cuda_ms(lambda: pack.pack_groups_sharded(
                 m, *args), REPS),
             "filter_pack": cuda_ms(lambda: pack.pack_groups(*args), REPS),
             "sharded_estimate": cuda_ms(lambda: estimate(m), REPS),
             "estimate": cuda_ms(lambda: estimate(None), REPS)}
        log(f"[mesh] ms as launched from Python (CUDA events, median of "
            f"{REPS}): pack_groups_sharded {t['sharded_pack']} vs K1's "
            f"filter pack {t['filter_pack']}; estimate_all with the mesh "
            f"{t['sharded_estimate']} vs without {t['estimate']} ({card})")
        # K1 alone on one rank's option slice of the (2, 1) mesh (the first
        # half of the options; the one-rank mesh's slice is the options row)
        (free3, mask3, *rest_args), _ = binpack.option_pack_inputs(
            rest, groups, dims, MAX_NEW_NODES)
        half = -(-free3.shape[0] // 2)
        slice_args = [free3[:half].contiguous(), mask3[:half].contiguous(),
                      *rest_args]
        k1_slice = k1_times(slice_args, pack_kernel.pack_groups_batched,
                            pack_kernel.pack_groups_batched_plain)
        log(f"[kernels] pack_groups_batched [mesh] option slice of one rank "
            f"of (2, 1) B={half} G={rest_args[0].shape[0]} "
            f"N={free3.shape[1]}: {k1_line(k1_slice)} ({card})")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
    gloo_launches = mesh_gloo_run(card)
    log(f"[mesh] phase took {time.perf_counter() - t_phase:.1f} s")
    return launches, gloo_launches, k1_slice


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one fused step and the control loop "
                         "(host and device); traces and stats go to DIR")
    ap.add_argument("--mesh-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-dir", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mesh_rank is not None:
        return mesh_rank_main(args.mesh_rank, args.mesh_dir)
    t_start = time.perf_counter()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the port itself: without the repo around this script, this fails here,
    # before anything is printed
    from kubernetes_autoscaler_tpu_torch.models.cluster_state import Dims
    from kubernetes_autoscaler_tpu_torch.ops.kernels import (
        build,
        con_cases,
        constrained_kernel,
        drain_cases,
        drain_kernel,
        drain_topo_cases,
        hist_cases,
        histogram_kernel,
        pack_cases,
        pack_kernel,
        pred_cases,
        predicate_kernel,
        wave_cases,
        wavefront_kernel,
    )

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{kind} x{torch.cuda.device_count()}")

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = build.build([pack_kernel.SOURCE, wavefront_kernel.SOURCE,
                        histogram_kernel.SOURCE, constrained_kernel.SOURCE,
                        drain_kernel.SOURCE, predicate_kernel.SOURCE])
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
    k3, k3_plain = (histogram_kernel.scatter_add_ordered,
                    histogram_kernel.scatter_add_ordered_plain)

    # 3. kernels against their plain versions on seeded cases
    k1_err = k2_err = 0
    for name, case in pack_cases.CASES.items():
        k1_err = max(k1_err, check_pack(
            name, [a.to(DEVICE) for a in case()], k1, k1_plain))
    for name, case in wave_cases.CASES.items():
        k2_err = max(k2_err, check_wave(
            name, [a.to(DEVICE) for a in case()], k2, k2_plain))
    k3_err = 0.0
    for name, case in hist_cases.CASES.items():
        k3_err = max(k3_err, check_hist(name, case(), k3, k3_plain))
    for row, bucket in hist_cases.OUT_OF_BANK:
        for n in (1, 100):
            k3_err = max(k3_err, check_hist(
                f"out of bank (row {row}, bucket {bucket}, n {n})",
                hist_cases.out_of_bank_case(row, bucket, n), k3, k3_plain))
    # a skewed batch (90 % of the samples in one row): a reported time
    skew_args = hist_cases.CASES["skewed"]()
    k3_skew = hist_times(skew_args, k3, k3_plain)
    log(hist_line("skewed case", skew_args, k3_skew))
    ck = constrained_kernel
    con_err = 0
    choice = ck.launch_choice
    try:
        # each case at the kernel's own cluster size and on a cluster of 16:
        # a "place" case through place_lanes (the place entry) and as the
        # pack_lanes call of its lanes (the pack entry); one launch each,
        # no read to the host
        for cluster in (0, 16):
            ck.launch_choice = lambda b, n, r, z, cluster=cluster: (cluster, 0)
            for name, build_case in con_cases.CASES.items():
                cpu_case = build_case()
                runs = {"": cpu_case}
                if cpu_case.kind == "place":
                    runs[" as one pack"] = con_cases.as_pack(cpu_case)
                for tag, case in runs.items():
                    case = case.to(DEVICE)
                    before = ck.launch.launches
                    with no_host_reads():
                        got = case.run(ck.place_lanes, ck.pack_lanes)
                    torch.cuda.synchronize()
                    if ck.launch.launches != before + 1:
                        raise AssertionError(f"case {name}{tag}: "
                                             f"{ck.launch.launches - before} "
                                             f"launches, expected 1")
                    con_err = max(con_err, check_con(
                        f"case {name}{tag}, cluster {cluster or 'chosen'}",
                        got, case.run(ck.place_lanes_plain,
                                      ck.pack_lanes_plain)))
    finally:
        ck.launch_choice = choice
    err, place_entry = check_place_group(card)
    con_err = max(con_err, err)
    drain_err = 0
    for name, case in drain_cases.CASES.items():
        case = case().to(DEVICE)
        drain_err = max(drain_err, check_drain(
            f"case {name}", case.inputs(), case.max_groups_per_node))
    topo_err = 0
    for name, case in drain_topo_cases.CASES.items():
        case = case().to(DEVICE)
        topo_err = max(topo_err, check_drain_topo(
            f"case {name}", *case.inputs(), case.max_groups_per_node)[0])
    # row P: every public function of ops/predicates.py on every case, one
    # launch each, byte-equal to the plain version on the card
    pred_err = 0
    for name, case in pred_cases.CASES.items():
        case = case().to(DEVICE)
        for func in pred_cases.FUNCTIONS:
            pred_err = max(pred_err, check_pred(
                f"case {name} {func}", pred_cases.plane_args(func, case)))
        for checks in (predicate_kernel.STATIC, predicate_kernel.ALL_CHECKS):
            for mask in (None, case.group_mask):
                pred_err = max(pred_err, check_pred(
                    f"case {name} residents checks={checks}"
                    f"{'' if mask is None else ' masked'}",
                    (case.nodes, case.specs, checks, False, mask,
                     case.scheduled)))
    log(f"[kernels] predicate plane == plain: {len(pred_cases.CASES)} cases x "
        f"({len(pred_cases.FUNCTIONS)} functions + the resident term with "
        f"2 check sets, with and without the group mask)")

    dims = Dims()
    # 4. the fused main path at full size; the drain kernel on its sweep
    (world, k1_launches, k1_entry, err, drain_main_launches,
     pred_main_launches) = main_phase(args, dims, k1, k1_plain)
    k1_err = max(k1_err, err)
    drain_entry, err = drain_phase(card, dims, world)
    drain_err = max(drain_err, err)
    # row P on the main step's own plane calls; the step with the plain plane
    pred_main, err = pred_phase(card, "[main]", main_step(*world, dims)[1], 3)
    pred_err = max(pred_err, err)
    # 5. the wavefront path at full size
    k2_launches, k2_entry, err = wavefront_phase(dims, world)
    k2_err = max(k2_err, err)
    # 6. the phased scale-down and run_once_sim on the main world
    phased_phase(dims, world)
    # 7. CPU against the card at 512 nodes
    cpu_card_phase(dims)
    # 8. the control loop at the bench_runonce_e2e world
    loop_launches, loop_per_loop, err, loop_ref, loop_a = loop_phase(
        card, dims, k1, k1_plain, args.profile)
    k1_err = max(k1_err, err)
    # 9. the control loop, CPU against the card at 512 nodes
    loop_cpu_card_phase(card)
    # 10. the what-if multiverse, branched from [loop]'s autoscaler
    whatif_launches = whatif_phase(card, loop_a)
    del loop_a
    # 11-13. the journal, the shadow audit and the replay at full width,
    # the cross-device replays, the command lines
    journal_launches = journal_phase(card, loop_ref)
    journal_cpu_card_phase(card)
    entry_launches = entry_phase(card)
    # 14-17. the constrained tier: the fused step at full width, the steps
    # CPU against the card, the control loop at full width and CPU against
    # the card
    con_launches, con_entry, err, topo_entry, pred_con = constrained_phase(
        dims, card, args.profile)
    pred_err = max(pred_err, pred_con.pop("max_abs_err"))
    con_err = max(con_err, err)
    topo_entry["max_abs_err"] = max(topo_entry["max_abs_err"], topo_err)
    constrained_cpu_card_phase(dims, card)
    loop_constrained_phase(card)
    loop_constrained_cpu_card_phase(card)
    # 18-19. the simulation sidecar: a fleet of tenants at full width,
    # batched against serial; CPU against the card
    side_launches, side_per_batch, err, side_times = sidecar_phase(
        card, dims, k1, k1_plain)
    k1_err = max(k1_err, err)
    sidecar_cpu_card_phase(card)
    # 20-21. the VPA recommender at a large cluster's scale on the card; the
    # same script on the CPU against it
    vpa_run_card, k3_launches, k3_entry, err = vpa_phase(card, k3, k3_plain)
    k3_err = max(k3_err, err)
    vpa_cpu_card_phase(card, vpa_run_card)
    del vpa_run_card
    # 22. the device mesh at [main]'s world: one rank, then two
    mesh_launches, mesh_gloo_launches, k1_slice = mesh_phase(card, dims,
                                                             world)

    # 23. result: `ms` is the kernel as launched from Python (CUDA events
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
        "journal_loop_launches": journal_launches["loop_launches"],
        "replay_launches": journal_launches["replay_launches"],
        "entry_launches": entry_launches,
        "whatif_launches": whatif_launches,
        "sidecar_launches": side_launches,
        "sidecar_launches_per_batch": side_per_batch,
        "sidecar_filter_ms": side_times["filter"]["launch"],
        "sidecar_filter_device_ms": side_times["filter"]["kernel"],
        "sidecar_options_ms": side_times["options"]["launch"],
        "sidecar_options_device_ms": side_times["options"]["kernel"],
        "mesh_launches": mesh_launches,
        "mesh_gloo_launches": mesh_gloo_launches,
        "mesh_slice_ms": k1_slice["launch"],
        "mesh_slice_device_ms": k1_slice["kernel"],
        "mesh_slice_plain_ms": k1_slice["plain"],
        "mesh_slice_bound_ms": k1_slice["bound"],
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
    }, {
        "name": "scatter_add_ordered",
        "route": "cuda",
        "source": "kubernetes_autoscaler_tpu_torch/csrc/histogram.cu",
        "replaces": "kubernetes_autoscaler_tpu/vpa/histogram.py:118",
        "launches": k3_launches,
        "max_abs_err": k3_err,
        **k3_entry,
        "skewed_ms": k3_skew["launch"],
        "skewed_device_ms": k3_skew["device"],
        "skewed_order_ms": k3_skew["order"],
        "skewed_library_ms": k3_skew["library"],
        "skewed_bound_ms": k3_skew["bound"],
        "checked": True,
        "shapes": "the VPA recommender: a RunOnce's memory-bank feed "
                  "(100,000 samples into 33,790 x 176 bins; ms, device_ms, "
                  "order_ms, plain_ms, bound_ms, library_ms there), the "
                  "history's CPU bank (history_*), hist_cases' skewed batch "
                  "(skewed_*, 60,000 samples, 90 % in one row, reported); "
                  "ms: as launched from Python, device_ms: every pass, "
                  "order_ms: the radix passes alone; XLA's scatter-add, no "
                  "Pallas kernel; library_ms: atomic index_add_ on bins and "
                  "totals; plain_ms: the plain version on the CPU",
    }, {
        "name": "constrained_wave_placer",
        "route": "cuda",
        "source": "kubernetes_autoscaler_tpu_torch/csrc/constrained.cu",
        "replaces": "kubernetes_autoscaler_tpu/ops/constrained.py:235",
        "launches": con_launches,
        "max_abs_err": con_err,
        **con_entry,
        **place_entry,
        "library_ms": None,
        "checked": True,
        "shapes": "[constrained]'s run_once_fused: the filter pack (pack_lanes "
                  "B=1, N=5120, G=64, a cluster of 16 CTAs; ms, device_ms, "
                  "plain_ms, bound_ms there), the options pack (B=NG, "
                  "N=max_new_nodes, one CTA a lane; options_*), 2 "
                  "launches a step (the drain's constrained slots run in the "
                  "drain kernel's topology mode); place_*: the place entry "
                  "(place_group_constrained, con_cases.group_case, N=5120, "
                  "off the steps' path); XLA's while_loop and scan, "
                  "no Pallas kernel; library_ms: no single PyTorch call "
                  "computes a constrained wave pack",
    }, {
        "name": "drain_sweep",
        "route": "cuda",
        "source": "kubernetes_autoscaler_tpu_torch/csrc/drain.cu",
        "replaces": "kubernetes_autoscaler_tpu/ops/drain.py:312",
        "launches": drain_main_launches,
        "max_abs_err": drain_err,
        **drain_entry,
        "library_ms": None,
        "checked": True,
        "shapes": "[main]'s run_once_fused: the scale-down sweep, every node a "
                  "candidate (C=N=5120, G=64, MPN=128, K=16; ms, device_ms, "
                  "plain_ms, bound_ms there), one launch a step (its C entry "
                  "runs the fit plane's pre-pass, then the sweep); the reason "
                  "pass (failure_reasons) is the same kernel; XLA's scan under "
                  "vmap, no Pallas kernel; library_ms: no single PyTorch call "
                  "computes a K-step first fit",
    }, {
        "name": "drain_sweep_topology",
        "route": "cuda",
        "source": "kubernetes_autoscaler_tpu_torch/csrc/drain.cu",
        "replaces": "kubernetes_autoscaler_tpu/ops/drain.py:308",
        **topo_entry,
        "library_ms": None,
        "checked": True,
        "shapes": "[constrained]'s run_once_fused: the constrained scale-down "
                  "sweep, the same kernel's topology mode (C=N=5120, G=64, "
                  "MPN=128, K=16, Z=16; ms, device_ms, plain_ms, bound_ms "
                  "there), one launch a step; all_active_*: the same widths "
                  "where every lane re-places by waves; XLA's scan with "
                  "lax.cond(is_con, slow, fast) under vmap, no Pallas kernel; "
                  "library_ms: no single PyTorch call computes it",
    }, pred_json(pred_main_launches, pred_err, pred_main, pred_con)]
    log(f"[result] chip_smoke.py ran {time.perf_counter() - t_start} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

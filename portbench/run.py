"""Run one cell of the port's benchmark once, on one CUDA card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (BENCHMARK.json `workloads`) is a configuration under a traffic mix.
Set-up draws the traffic's V world variants from the seed, encodes each with
the port's encoder and runs every variant's decision twice (the kernels load
from the port's build directory, which the first run of a checkout fills).
The window then asks for one fused decision at a time, as the control loop
does (closed loop, one client): request i runs variant i mod V through
`run_once_fused`, and ends when its decision is on the host
(`fetch_pytree`). It lasts `--seconds`, or one decision past.

With `--trace 0` the result line carries the cell's end-to-end metrics:
decision_ms_p95 (every decision's latency in the window), decisions_per_s
(all decisions over the window), device_ms_per_decision (the device's busy
time over the traced decisions, below, a decision), peak_device_mib
(max_memory_allocated from before the port's set-up to the window's end) and
setup_s (process start to the first timed decision). With `--trace 1` the
window also records CUDA events at the phase boundaries and the enqueue
time. After the window, in a `--trace 1` run or where an end-to-end metric
of the cell comes from the device trace, 4 more cycles of decisions run
under torch.profiler. The per-layer metrics are read from all of that by
metrics/<name>.py.

Once the window has closed and the peak is read, the program's state is
freed and the reference (reference/decide.py) works out every variant's
decision on the host from the same plain description; judge.py compares a
sample of the window's decisions, drawn from the seed, with it. The compared
numbers and their limits are the last lines on standard error and the
result's last key.

Exits non-zero with no result line without CUDA, with fewer cards than the
cell asks for, or when JAX or the JAX package is loaded at the end.
"""

from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import platform  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import judge, spec, world  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "kubernetes_autoscaler_tpu")
TRACE_CYCLES = 4        # cycles of V decisions under the profiler
SAMPLE_EVERY = 16       # about one window decision in this many is compared
WARMUP_ROUNDS = 2       # decisions of each variant at set-up


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def trace_dir() -> str:
    """Where a traced run writes its Chrome trace: TMPDIR, which the caller
    gives each side of a comparison apart, or else `.portbench_out/` in the
    checkout."""
    d = os.environ.get("TMPDIR") or os.path.join(spec.ROOT, ".portbench_out")
    os.makedirs(d, exist_ok=True)
    return d


def host_probe_ms() -> float:
    """ms that a fixed piece of pure Python work takes: the host's speed for
    the kind of work that paces a decision, comparable between runs and
    machines."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(400_000):
        acc = (acc + i * i) % 1_000_003
    return (time.perf_counter() - t0) * 1e3


def host_line() -> str:
    """The host's processor, its clock and load now: what the host-paced
    metrics depend on, for telling hosts apart."""
    model, mhz = None, []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip().lower()
                if key in ("model name", "cpu part") and model is None:
                    model = value.strip()
                elif key == "cpu mhz":
                    mhz.append(float(value))
    except (OSError, ValueError):
        pass
    clock = f"{statistics.fmean(mhz):.0f} MHz mean of {len(mhz)}" if mhz else "no clock"
    return (f"{model or platform.machine() or 'unknown'}, {clock}, "
            f"{os.cpu_count()} cpus, load "
            f"{' '.join(f'{x:.2f}' for x in os.getloadavg())}")


def host_counters() -> tuple[list[int], object]:
    """(the machine's CPU time by kind from /proc/stat, in ticks: user,
    nice, system, idle, iowait, irq, softirq, steal; this process's
    resource usage)."""
    import resource

    try:
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        ticks = []
    return ticks, resource.getrusage(resource.RUSAGE_SELF)


def host_share(before, after, window_s: float) -> str:
    """What else the machine did over the window: the share of all its CPU
    time that the hypervisor took (steal) and that was busy outside this
    process, and this process's involuntary context switches."""
    (t0, r0), (t1, r1) = before, after
    own = (r1.ru_utime + r1.ru_stime) - (r0.ru_utime + r0.ru_stime)
    out = f"{r1.ru_nivcsw - r0.ru_nivcsw} involuntary context switches"
    if len(t0) == len(t1) == 8:
        d = [b - a for a, b in zip(t0, t1)]
        total = sum(d) or 1
        hz = os.sysconf("SC_CLK_TCK")
        busy = total - d[3] - d[4] - d[7]
        out += (f"; steal {100.0 * d[7] / total:.2f} % of the machine's CPU "
                f"time, busy outside this process "
                f"{100.0 * max(busy - own * hz, 0) / total:.2f} % "
                f"({os.cpu_count()} cpus, {window_s:.1f} s)")
    return out


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


class Ctx:
    """What the per-layer readers (metrics/<name>.py) read."""

    def __init__(self):
        self.enqueue_ms: list[float] = []
        self.lat_ms: list[float] = []       # every window decision's latency
        self.n_done = 0                     # decisions in the window
        self.window_s = 0.0
        self.phase_ms: dict[str, list[float]] = {}
        self.traced = None
        self.work: dict[int, list] = {}
        self.notes: list[str] = []

    @staticmethod
    def mean(xs):
        return statistics.fmean(xs) if xs else None

    def mean_phase_ms(self, phase: str):
        return self.mean(self.phase_ms.get(phase, []))

    def roofline(self, key: str, kernels) -> float | None:
        """100 x the bound of the traced decisions' `key` calls over the
        named kernels' device time; None where either is missing."""
        from portbench import bounds

        t = self.traced
        if t is None:
            return None
        device_ms = t.kernel_ms(kernels)
        by_kind = {"bytes": 0.0, "operations": 0.0}
        for v in t.variants:
            for kernel, nbytes, ops in self.work.get(v, []):
                if kernel == key:
                    ms, kind = bounds.bound_ms(nbytes, ops)
                    by_kind[kind] += ms
        bound = sum(by_kind.values())
        if device_ms <= 0 or bound <= 0:
            return None
        kind = max(by_kind, key=by_kind.get)
        self.notes.append(
            f"{key}_roofline: bound {bound} ms ({kind}: {by_kind[kind]} ms), "
            f"device {device_ms} ms over {t.decisions} decisions")
        return 100.0 * bound / device_ms


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", bench: dict | None = None,
             cfg_overrides: dict | None = None,
             traffic_overrides: dict | None = None, program_cls=None) -> dict:
    """One run of the cell; returns the result line's object. The tests
    call it on the CPU with smaller configurations (`cfg_overrides`) and
    stand-in programs (`program_cls`), and smaller traffic
    (`traffic_overrides`)."""
    import torch

    from portbench.program import Program
    from portbench.reference import decide as ref

    bench = bench or spec.benchmark()
    cell = spec.cell(bench, workload)
    end_to_end = spec.metrics_for(bench, "end_to_end", workload)
    cfg = {**spec.load("configs", cell["config"]), **(cfg_overrides or {})}
    traffic = {**spec.load("traffic", cell["traffic"]),
               **(traffic_overrides or {})}
    on_card = device != "cpu"
    log(f"host: {host_line()}; probe {host_probe_ms()} ms")
    if on_card:
        log(f"card: {card_line()}; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")
        torch.cuda.reset_peak_memory_stats()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # ---------------------------------------------------------------- set-up
    variants = world.variants(cfg, traffic, seed)
    n_var = len(variants)
    t_enc = time.time()
    prog = (program_cls or Program)(cfg, traffic, variants, device)
    log(f"set-up: {n_var} variants built and encoded in "
        f"{time.time() - t_enc:.3f} s; pending pods a variant "
        f"{[sum(v.counts) + v.burst for v in variants]}, residents "
        f"{[int(v.residents.sum()) for v in variants]}")
    for _ in range(WARMUP_ROUNDS):
        for v in range(n_var):
            prog.fetch(prog.decide(v))
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts):
            prog.fetch(prog.decide(0))
    sync()
    # the set-up's garbage (the worlds' objects) is collected here, not by a
    # collection that its size would set off inside the window, and what
    # set-up keeps is left out of the window's collections
    gc.collect()
    gc.freeze()
    setup_s = time.time() - PROCESS_START

    # ---------------------------------------------------------------- window
    ctx = Ctx()
    keep_rng = world.rng_for(seed, 3)
    kept: list[tuple[int, object]] = []
    lat_ms: list[float] = []
    phase_events = []
    done_at: list[float] = []
    i = 0
    cpu_start = time.process_time()
    counters = host_counters()
    t_start = time.perf_counter()
    while True:
        v = i % n_var
        events = {}
        if trace:
            def on_phase(name, events=events):
                if on_card:
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    events[name] = ev
        else:
            on_phase = None
        t0 = time.perf_counter()
        decision = prog.decide(v, on_phase)
        t1 = time.perf_counter()
        host = prog.fetch(decision)
        t2 = time.perf_counter()
        lat_ms.append((t2 - t0) * 1e3)
        done_at.append(t2 - t_start)
        if trace:
            ctx.enqueue_ms.append((t1 - t0) * 1e3)
            phase_events.append(events)
        if i < n_var or keep_rng.random() < 1.0 / SAMPLE_EVERY:
            kept.append((v, host))
        i += 1
        if t2 - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    cpu_s = time.process_time() - cpu_start
    counters = (counters, host_counters())
    kept.append((v, host))
    n_done = i
    ctx.lat_ms, ctx.n_done, ctx.window_s = lat_ms, n_done, window_s
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if trace and on_card:
        bounds_ = list(prog.phases) + ["end"]
        for events in phase_events:
            for a, b in zip(bounds_, bounds_[1:]):
                ctx.phase_ms.setdefault(a, []).append(
                    events[a].elapsed_time(events[b]))

    device_e2e = on_card and any(m["source"] == "device_trace"
                                 for m in end_to_end)
    if trace or device_e2e:
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        from portbench.trace import Traced

        traced_vars = []
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        sync()
        with profile(activities=acts) as prof:
            # one decision before the window: the profiler misses some of
            # the launches it sees first
            prog.fetch(prog.decide(0))
            sync()
            with record_function("portbench.window"):
                for j in range(TRACE_CYCLES * n_var):
                    with record_function("portbench.next"):
                        v = j % n_var
                        traced_vars.append(v)
                    with record_function("portbench.enqueue"):
                        decision = prog.decide(v)
                    with record_function("portbench.fetch"):
                        host = prog.fetch(decision)
                sync()
            # and a cycle after it: the profiler may drop the last launches
            # it sees before it stops
            for j in range(n_var):
                prog.fetch(prog.decide(j))
            sync()
        if on_card:
            ctx.traced = Traced(prof, len(traced_vars), traced_vars)
        kept.append((v, host))

    del prog, decision
    if on_card:
        torch.cuda.empty_cache()
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"forbidden modules loaded: {bad}")

    # ------------------------------------------------------------- reference
    t_ref = time.time()
    numbers = {"exact_mismatches": 0, "float_gap": 0.0}
    failed = 0
    for v in range(n_var):
        want, ctx.work[v] = ref.decide(cfg, traffic, variants[v], record=trace)
        for kv, got_tree in kept:
            if kv != v:
                continue
            m, g = judge.against(judge.flatten(got_tree), want)
            numbers["exact_mismatches"] += m
            numbers["float_gap"] = max(numbers["float_gap"], g)
            failed += int(not judge.verdict({"exact_mismatches": m,
                                             "float_gap": g}))
    log(f"reference: {n_var} variants worked out again and "
        f"{len(kept)} decisions compared in {time.time() - t_ref:.3f} s")
    correct = judge.verdict(numbers)

    # --------------------------------------------------------------- metrics
    lat = np.asarray(lat_ms)
    log(f"window: {n_done} decisions in {window_s} s; latency ms p50 "
        f"{float(np.percentile(lat, 50))} p95 {float(np.percentile(lat, 95))} "
        f"max {float(lat.max())} over {lat.size} samples")
    fifths = np.histogram(done_at, bins=5, range=(0.0, window_s))[0] / (window_s / 5)
    log(f"window: decisions/s by fifth {fifths.round(2).tolist()}; the "
        f"process's CPU time {cpu_s} s of {window_s} s")
    log(f"host after the window: {host_line()}; probe {host_probe_ms()} ms; "
        f"over the window: {host_share(*counters, window_s)}")
    values = {
        "decision_ms_p95": float(np.percentile(lat, 95)),
        "decisions_per_s": n_done / window_s,
        "peak_device_mib": peak / 2 ** 20,
        "setup_s": setup_s,
    }
    if ctx.traced is not None:
        t = ctx.traced
        values["device_ms_per_decision"] = 1e3 * t.busy_s / t.decisions
        log(f"traced: {t.decisions} decisions, device busy {t.busy_s} s "
            f"of {t.window_s} s")
    metrics = {}
    if not trace:
        for m in end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in spec.metrics_for(bench, "per_layer", workload):
            val = spec.reader(m["name"])(ctx)
            if val is not None:
                metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
        for note in ctx.notes:
            log(note)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": n_done, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and ctx.traced is not None:
        t = ctx.traced
        dev["busy_s"] = t.busy_s
        dev["window_s"] = t.window_s
        result["breakdown"] = {"device_ops": t.top_ops(), "idle_gaps": t.idle_gaps()}
        path = os.path.join(trace_dir(),
                            f"portbench-{workload}-{seed}.trace.json.gz")
        t.write(path)
        log(f"trace: {path}")
    result["limits"] = judge.report(numbers)
    for k, r in result["limits"].items():
        log(f"check {k}: {r['value']} (limit {r['limit']})")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative whole number")

    import torch

    bench = spec.benchmark()
    chips = spec.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      bench=bench)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded in this process: {bad}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Device-side observability: HBM residency ledger, compile census, profiler.

The port's copy of the reference package's metrics/device.py. The device
reads are PyTorch's: `torch.cuda.memory_stats` and the device's total
memory for the ledger, the kernel build cache (ops/kernels/build.py) for
the compile census, `torch.profiler` for captures and
`torch.cuda.memory_stats` for the OOM dump.

Every observability surface before this module was host-side — spans,
lifecycle stamps, journal records all measure what the HOST did around a
dispatch. This module instruments the DEVICE's shared resources
(docs/OBSERVABILITY.md "Device surfaces"):

  ResidencyLedger  who holds how much HBM. Every component that keeps
                   device arrays resident across loops — the WorldStore's
                   DevicePlaneStore, the sidecar tenants' export/device
                   tiers, the StackCache, the orchestrator's marshalled
                   group tensors — registers them under an owner tag (and a
                   tenant, where one exists). The ledger holds WEAK
                   references: a freed buffer falls out of the census by
                   itself, so tagged bytes track LIVE residency, not
                   registration history. `reconcile()` compares the tagged
                   census against `device.memory_stats()` totals
                   (`hbm_bytes_in_use` / `hbm_bytes_limit` /
                   `hbm_headroom_ratio`) — the untagged remainder is the
                   blind spot the LeakWatchdog watches. On backends without
                   memory_stats (CPU) the reconciliation degrades to a
                   host-RSS report with `source: host-fallback`, never null.

  LeakWatchdog     K consecutive loops of monotonic untagged-bytes growth
                   ⇒ a leak suspect: something holds device memory no owner
                   tagged. Fires once per streak (event + flight-recorder
                   dump at the call site), counted by
                   `hbm_leak_suspects_total`.

  CompileCensus    which shape signature compiled, for which tenant. Wraps
                   the dispatch entry points: when a call grows the kernel
                   build cache, the census records a variant entry keyed by
                   (fn, shape signature) and the tenant the build was
                   charged to — so `sim_compiles_total` and
                   `recompiles_per_new_tenant` resolve to named variants on
                   Statusz and /metrics instead of bare counts.

  DeviceProfiler   breach-triggered on-device profiling. Armed by the
                   TailSampler retention / SLO-breach path (or the sidecar
                   `Profilez` RPC / an operator), the NEXT dispatch runs
                   under a bounded `torch.profiler` session whose
                   capture directory is stamped (meta.json) with the
                   retained trace id and journal cursor — a slow trace in
                   the tail ring links to a real device timeline. Captures
                   are rate-limited and capped; disarmed costs one module
                   global load at the dispatch site (the fault-hook guard
                   contract of sidecar/faults.py).

Zero-overhead discipline: `LEDGER`, `PROFILER` and `CENSUS` are module
globals defaulting to None. Hot-path call sites guard with
`if device.LEDGER is not None:` — one global load when the facility is off.
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref

HBM_IN_USE_HELP = ("Device memory in use (device.memory_stats().bytes_in_use"
                   "; 0 with source=host-fallback)")
HBM_LIMIT_HELP = ("Device memory limit (device.memory_stats().bytes_limit, "
                  "or the configured --hbm-limit-bytes override)")
HBM_HEADROOM_HELP = ("(limit - in_use) / limit — the admission headroom the "
                     "--hbm-budget-frac gate protects")
RESIDENT_HELP = ("Live device bytes tagged in the residency ledger, by "
                 "owner component and tenant (weakref census: freed buffers "
                 "drop out by themselves)")
TENANT_HBM_HELP = ("Live device bytes attributed to one tenant across every "
                   "owner tag — the projected-residency base the HBM budget "
                   "admission gate charges against")
LEAK_HELP = ("Leak-watchdog firings: K consecutive loops of monotonic "
             "untagged device-byte growth (memory no ledger owner tagged)")
OOM_DUMP_HELP = ("Device-memory pprof snapshots persisted on a "
                 "RESOURCE_EXHAUSTED/OOM dispatch failure")
CENSUS_HELP = ("Compiles recorded by the compile census, by jit entry "
               "point, shape signature and the tenant charged")
PROFILER_CAPTURES_HELP = ("Bounded torch.profiler sessions captured, "
                          "by the reason that armed them")

# module globals (the sidecar/faults.py pattern): None = facility off, and
# every hot-path site costs exactly one global load + identity test
LEDGER: "ResidencyLedger | None" = None
PROFILER: "DeviceProfiler | None" = None


def memory_stats() -> dict | None:
    """Bytes in use and the limit of the current CUDA device, or None
    without one. Never raises."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        stats = torch.cuda.memory_stats()
        return {"bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                              0)),
                "bytes_limit": int(torch.cuda.get_device_properties(
                    torch.cuda.current_device()).total_memory)}
    except Exception:  # noqa: BLE001 — no driver / early init
        return None


def host_rss_bytes() -> int:
    """CURRENT resident set size of this process — the host-fallback total
    when the device reports no memory_stats. /proc gives the live figure;
    the getrusage fallback is the lifetime PEAK (ru_maxrss — and already
    bytes on macOS), which can only overstate, never hide, growth."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:  # noqa: BLE001 — non-linux
        try:
            import resource
            import sys

            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            return int(rss) if sys.platform == "darwin" else int(rss) * 1024
        except Exception:  # noqa: BLE001 — non-unix
            return 0


def _device_leaves(arrays) -> list:
    """Flatten `arrays` (a tensor, dict, list/tuple, or tensor dataclass)
    into its tensor leaves. Host numpy mirrors are ignored — this is a
    device-memory ledger, and counting host bytes would corrupt the
    tagged-vs-total reconciliation."""
    import torch

    from kubernetes_autoscaler_tpu_torch.ops.hostfetch import _flatten

    return [x for x in _flatten(arrays, []) if isinstance(x, torch.Tensor)]


def device_bytes(arrays) -> int:
    """Total bytes of the DEVICE-array leaves of a pytree (the projection
    the serial-tier budget screen prices an assembled world with)."""
    return sum(int(a.nbytes) for a in _device_leaves(arrays))


class ResidencyLedger:
    """Owner/tenant-tagged census of live device arrays.

    Entries are keyed by (owner, tenant, key); each holds weak references
    to the registered device arrays plus their byte sizes. Re-tracking a
    key REPLACES the entry (the upload path's natural idiom: a refreshed
    plane re-registers under the same key). A dead weakref contributes 0 —
    `census()` sweeps entries whose every array died."""

    def __init__(self):
        self._entries: dict[tuple, list] = {}   # key -> [(ref, nbytes), ...]
        self._lock = threading.Lock()
        # last-published gauge label sets PER REGISTRY, for stale-series
        # zeroing (the reason-plane convention): the one process ledger
        # reconciles into BOTH the control loop's registry and the sidecar's
        # — each must see its own vanished series zeroed, so the bookkeeping
        # cannot be shared (weak keys: a dropped registry takes its set)
        self._published = weakref.WeakKeyDictionary()

    def track(self, owner: str, key: str, arrays, tenant: str = "") -> int:
        """Register `arrays` (replacing any prior registration of this
        (owner, tenant, key)). Returns the live bytes registered."""
        refs = []
        total = 0
        for a in _device_leaves(arrays):
            try:
                refs.append((weakref.ref(a), int(a.nbytes)))
                total += int(a.nbytes)
            except TypeError:  # pragma: no cover — unweakrefable leaf
                continue
        with self._lock:
            if refs:
                self._entries[(owner, tenant, key)] = refs
            else:
                self._entries.pop((owner, tenant, key), None)
        return total

    def release(self, owner: str | None = None, tenant: str | None = None,
                key: str | None = None) -> int:
        """Drop every entry matching the given tags (None = wildcard);
        returns how many entries were dropped. Belt-and-braces — weakref
        expiry already removes freed arrays from the census."""
        with self._lock:
            victims = [k for k in self._entries
                       if (owner is None or k[0] == owner)
                       and (tenant is None or k[1] == tenant)
                       and (key is None or k[2] == key)]
            for k in victims:
                del self._entries[k]
            return len(victims)

    def census(self) -> dict:
        """Live tagged bytes: {"by_owner_tenant": {(owner, tenant): bytes},
        "tagged_bytes": total, "entries": live entry count}. Sweeps entries
        whose arrays all died."""
        by: dict[tuple, int] = {}
        with self._lock:
            dead = []
            for (owner, tenant, _key), refs in self._entries.items():
                live = sum(nb for ref, nb in refs if ref() is not None)
                if live == 0 and all(ref() is None for ref, _ in refs):
                    dead.append((owner, tenant, _key))
                    continue
                by[(owner, tenant)] = by.get((owner, tenant), 0) + live
            for k in dead:
                del self._entries[k]
            n = len(self._entries)
        return {"by_owner_tenant": by,
                "tagged_bytes": sum(by.values()),
                "entries": n}

    def tenant_bytes(self, tenant: str) -> int:
        return sum(v for (_o, t), v in
                   self.census()["by_owner_tenant"].items() if t == tenant)

    def tagged_bytes(self) -> int:
        return self.census()["tagged_bytes"]

    # ---- reconciliation + publication ----

    def reconcile(self, registry=None, hbm_limit_bytes: int = 0) -> dict:
        """Tagged census vs the device's own accounting, published as
        gauges when a registry is attached. On backends with memory_stats
        the `untagged_bytes` remainder is real unattributed HBM (allocator
        overhead, XLA temp buffers, anything nobody tagged) — the quantity
        the LeakWatchdog watches; on CPU the report degrades to host RSS
        with `source: host-fallback` and untagged tracks RSS growth
        instead."""
        c = self.census()
        ms = memory_stats()
        if ms and ms.get("bytes_in_use") is not None:
            in_use = int(ms["bytes_in_use"])
            limit = int(hbm_limit_bytes or ms.get("bytes_limit") or 0)
            source = "device"
        else:
            in_use = host_rss_bytes()
            limit = int(hbm_limit_bytes or 0)
            source = "host-fallback"
        untagged = max(in_use - c["tagged_bytes"], 0)
        headroom = ((limit - in_use) / limit) if limit > 0 else None
        out = {
            "source": source,
            "bytes_in_use": in_use,
            "bytes_limit": limit,
            "tagged_bytes": c["tagged_bytes"],
            "untagged_bytes": untagged,
            "headroom_ratio": headroom,
            "entries": c["entries"],
            "by_owner_tenant": {
                f"{o}/{t or 'default'}": v
                for (o, t), v in sorted(c["by_owner_tenant"].items())},
            "tenants": {},
        }
        tenants: dict[str, int] = {}
        for (_o, t), v in c["by_owner_tenant"].items():
            tenants[t] = tenants.get(t, 0) + v
        out["tenants"] = {t or "default": v
                          for t, v in sorted(tenants.items())}
        if registry is not None:
            self._publish(registry, out, c["by_owner_tenant"], tenants)
        return out

    def _publish(self, registry, rec: dict, by_ot: dict,
                 tenants: dict) -> None:
        registry.gauge("hbm_bytes_in_use", help=HBM_IN_USE_HELP).set(
            float(rec["bytes_in_use"] if rec["source"] == "device" else 0.0))
        registry.gauge("hbm_bytes_limit", help=HBM_LIMIT_HELP).set(
            float(rec["bytes_limit"]))
        if rec["headroom_ratio"] is not None:
            registry.gauge("hbm_headroom_ratio", help=HBM_HEADROOM_HELP).set(
                float(rec["headroom_ratio"]))
        with self._lock:
            prev_ot, prev_t = self._published.get(registry, (set(), set()))
        resident = registry.gauge("resident_bytes", help=RESIDENT_HELP)
        live = {(o, t or "default") for (o, t) in by_ot}
        for owner, tenant in prev_ot - live:
            resident.set(0.0, owner=owner, tenant=tenant)
        for (o, t), v in by_ot.items():
            resident.set(float(v), owner=o, tenant=t or "default")
        per_tenant = registry.gauge("tenant_hbm_bytes", help=TENANT_HBM_HELP)
        live_t = {t or "default" for t in tenants}
        for tenant in prev_t - live_t:
            per_tenant.set(0.0, tenant=tenant)
        for t, v in tenants.items():
            per_tenant.set(float(v), tenant=t or "default")
        with self._lock:
            self._published[registry] = (live, live_t)


def enable_ledger() -> ResidencyLedger:
    """Install (or return) the process ledger. Idempotent — the sidecar
    service and the control loop share one census; their registries differ,
    but publication is per-reconcile-call, so both surfaces stay honest."""
    global LEDGER
    if LEDGER is None:
        LEDGER = ResidencyLedger()
    return LEDGER


def disable_ledger() -> None:
    """Tests + the disabled-overhead microbench."""
    global LEDGER
    LEDGER = None


class LeakWatchdog:
    """K consecutive observations of monotonic untagged growth ⇒ suspect.

    `observe(untagged_bytes)` is called once per loop with the
    reconciliation's untagged remainder; growth below `min_growth_bytes`
    per step is jitter (allocator rounding, host RSS noise on the fallback
    path) and RESETS the streak. On firing, returns a report dict (the
    caller emits the event + flight-recorder dump — this module has no
    event sink of its own) and the streak restarts, so a sustained leak
    fires once per K-loop window, not once per loop."""

    def __init__(self, k: int = 5, min_growth_bytes: int = 1 << 20,
                 registry=None):
        self.k = max(int(k), 2)
        self.min_growth_bytes = int(min_growth_bytes)
        self.registry = registry
        self._last: int | None = None
        self._streak = 0
        self._streak_base = 0
        self.fired = 0

    def observe(self, untagged_bytes: int) -> dict | None:
        untagged_bytes = int(untagged_bytes)
        prev = self._last
        self._last = untagged_bytes
        if prev is None or untagged_bytes < prev + self.min_growth_bytes:
            self._streak = 0
            return None
        if self._streak == 0:
            self._streak_base = prev
        self._streak += 1
        if self._streak < self.k:
            return None
        report = {
            "loops": self._streak,
            "grew_bytes": untagged_bytes - self._streak_base,
            "untagged_bytes": untagged_bytes,
        }
        self._streak = 0
        self.fired += 1
        if self.registry is not None:
            self.registry.counter("hbm_leak_suspects_total",
                                  help=LEAK_HELP).inc()
        return report


# ---- compile census -------------------------------------------------------

def shape_signature(args, kwargs=None) -> str:
    """Short, stable signature of a call's tensor shapes: the variant key.
    Array leaves contribute dtype[dims]; non-array leaves (static config)
    contribute their repr — two calls with equal signatures hit the same
    jit cache entry (the signature is a superset of jit's own key content
    for our entry points, which never close over arrays)."""
    import hashlib

    from kubernetes_autoscaler_tpu_torch.ops.hostfetch import _flatten

    def _leaves(tree):
        # tensors through the port's tree walk; scalars and config too
        out = []
        if isinstance(tree, (tuple, list)):
            for v in tree:
                out.extend(_leaves(v))
        elif isinstance(tree, dict):
            for k in sorted(tree):
                out.extend(_leaves(tree[k]))
        elif hasattr(tree, "__dataclass_fields__") and not hasattr(
                tree, "shape"):
            tensors = _flatten(tree, [])
            out.extend(tensors if tensors else [tree])
        else:
            out.append(tree)
        return out

    parts = []
    for leaf in _leaves((args, kwargs or {})):
        shape = getattr(leaf, "shape", None)
        if shape is not None:
            parts.append(f"{getattr(leaf, 'dtype', '?')}"
                         f"[{','.join(map(str, shape))}]")
        else:
            parts.append(repr(leaf))
    spec = "|".join(parts)
    lead = ""
    for leaf in _leaves((args, kwargs or {})):
        shape = getattr(leaf, "shape", None)
        if shape is not None:
            lead = "x".join(map(str, shape))
            break
    return (f"{lead or 'scalar'}/"
            f"{hashlib.sha1(spec.encode()).hexdigest()[:8]}")


class CompileCensus:
    """Per-variant table for the dispatch entry points.

    `dispatch(label, fn, args, kwargs, tenant=)` runs one call and, when
    the call GREW the kernel build cache (ops/kernels/build.cache_size: a
    real build on the dispatch path), records a variant entry keyed by
    (label, shape signature): compile count and the tenant charged (the
    fresh tenant of a `recompiles_per_new_tenant` window, "" for
    steady/local work). PyTorch has no per-program cost analysis, so a
    variant carries no flops/bytes figures (ROADMAP A8)."""

    # what a variant's compile is: growth of the kernel build cache (the
    # sidecar's Statusz prints it beside the variant count)
    mode = "build-cache"

    def __init__(self, registry=None):
        self.registry = registry
        self._table: dict[tuple, dict] = {}
        self._lock = threading.Lock()

    def dispatch(self, label: str, fn, args=(), kwargs=None, tenant: str = ""):
        """The census-wrapped dispatch: returns fn(*args, **kwargs);
        records a variant when the call grew the kernel build cache."""
        from kubernetes_autoscaler_tpu_torch.ops.kernels.build import (
            cache_size,
        )

        kwargs = kwargs or {}
        c0 = cache_size()
        out = fn(*args, **kwargs)
        if cache_size() > c0:
            self.record(label, args, kwargs, tenant=tenant)
        return out

    def record(self, label: str, args=(), kwargs=None,
               tenant: str = "") -> dict:
        sig = shape_signature(args, kwargs)
        entry_key = (label, sig)
        with self._lock:
            e = self._table.get(entry_key)
            if e is None:
                e = self._table[entry_key] = {
                    "fn": label, "shape_sig": sig, "compiles": 0,
                    "tenants": [],
                }
            e["compiles"] += 1
            if tenant and tenant not in e["tenants"]:
                e["tenants"].append(tenant)
            rec = dict(e)
        if self.registry is not None:
            self.registry.counter(
                "compile_census_total", help=CENSUS_HELP).inc(
                fn=label, shape_sig=sig, tenant=tenant or "default")
        return rec

    def variants(self) -> list[dict]:
        with self._lock:
            return [dict(v) for _k, v in sorted(self._table.items())]

    def zero_tenant(self, tenant: str) -> None:
        """drop_tenant sweep: the census table keeps its variants (the
        compiled programs outlive the tenant) but the tenant's charge
        attribution is removed."""
        with self._lock:
            for e in self._table.values():
                if tenant in e["tenants"]:
                    e["tenants"].remove(tenant)


# ---- breach-triggered profiler -------------------------------------------

class DeviceProfiler:
    """Bounded, rate-limited on-device profiler sessions.

    arm(reason, ...) marks the NEXT guarded dispatch for capture; the call
    site (server._timed_sim, StaticAutoscaler.run_once) wraps that one
    dispatch in `torch.profiler.profile` (trace.json in capture_dir) and writes meta.json
    stamping the capture with the reason, the retained trace id and the
    journal cursor — the link from tail-ring evidence to a device timeline.
    Rate limiting: one armed session at a time, `min_interval_s` between
    captures, `max_captures` per process lifetime. Disarmed cost at the
    dispatch site is the module-global guard (`device.PROFILER is None` or
    `.armed` False: two attribute loads)."""

    def __init__(self, dir_path: str, min_interval_s: float = 30.0,
                 max_captures: int = 8, registry=None,
                 clock=time.monotonic):
        self.dir = dir_path
        self.min_interval_s = float(min_interval_s)
        self.max_captures = int(max_captures)
        self.registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        self._armed: dict | None = None
        self._last_capture = -float("inf")
        self.captures: list[dict] = []
        self.throttled = 0

    @property
    def armed(self) -> bool:
        return self._armed is not None

    def arm(self, reason: str, trace_id: str = "",
            journal_cursor=None) -> bool:
        """True when armed; False when throttled (already armed, inside the
        rate-limit window, or the capture cap is spent)."""
        with self._lock:
            if (self._armed is not None
                    or len(self.captures) >= self.max_captures
                    or self._clock() - self._last_capture
                    < self.min_interval_s):
                self.throttled += 1
                return False
            self._armed = {
                "reason": reason,
                "trace_id": trace_id,
                "journal_cursor": (list(journal_cursor)
                                   if journal_cursor else None),
                "armed_at": time.time(),
            }
            return True

    def capture(self, fn):
        """Run `fn` under the armed profiler session (call only when
        `.armed`); returns (result, capture_path|None). The session is
        consumed whether the capture succeeded or not — a broken profiler
        must not re-fire on every subsequent dispatch."""
        with self._lock:
            meta = self._armed
            self._armed = None
            if meta is not None:
                seq = len(self.captures)
                self._last_capture = self._clock()
        if meta is None:      # lost the race with another dispatcher —
            return fn(), None  # run OUTSIDE the lock (fn can be seconds)
        tag = meta["trace_id"] or "manual"
        path = os.path.join(self.dir, f"capture-{seq:03d}-{tag}")
        # the profiler context is entered/exited under its own guards so a
        # broken profiler degrades to a plain call — but an exception from
        # fn() ITSELF always propagates and fn never runs twice (a captured
        # RunOnce that raises must not re-actuate)
        ctx = None
        try:
            import torch

            os.makedirs(path, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            ctx = torch.profiler.profile(activities=acts)
            ctx.__enter__()
        except Exception:  # noqa: BLE001 — profiling must not sink dispatch
            ctx, path = None, None
        try:
            out = fn()
        finally:
            if ctx is not None:
                try:
                    ctx.__exit__(None, None, None)
                    ctx.export_chrome_trace(
                        os.path.join(path, "trace.json"))
                except Exception:  # noqa: BLE001
                    path = None
        if path is not None:
            meta = dict(meta, path=path, seq=seq)
            try:
                with open(os.path.join(path, "meta.json"), "w") as f:
                    json.dump(meta, f, indent=1, sort_keys=True)
            except OSError:
                pass
            with self._lock:
                self.captures.append(meta)
            if self.registry is not None:
                self.registry.counter(
                    "device_profile_captures_total",
                    help=PROFILER_CAPTURES_HELP).inc(reason=meta["reason"])
        return out, path

    def stats(self) -> dict:
        with self._lock:
            return {
                "dir": self.dir,
                "armed": self._armed is not None,
                "armed_reason": (self._armed or {}).get("reason"),
                "captures": len(self.captures),
                "max_captures": self.max_captures,
                "min_interval_s": self.min_interval_s,
                "throttled": self.throttled,
                "last": dict(self.captures[-1]) if self.captures else None,
            }


def install_profiler(dir_path: str, min_interval_s: float = 30.0,
                     max_captures: int = 8, registry=None) -> DeviceProfiler:
    """Install the process profiler (idempotent per directory: re-installing
    with the same dir returns the existing session so sidecar + control
    loop in one process share the rate limiter)."""
    global PROFILER
    if PROFILER is None or PROFILER.dir != dir_path:
        PROFILER = DeviceProfiler(dir_path, min_interval_s=min_interval_s,
                                  max_captures=max_captures,
                                  registry=registry)
    elif registry is not None and PROFILER.registry is None:
        PROFILER.registry = registry
    return PROFILER


def uninstall_profiler() -> None:
    global PROFILER
    PROFILER = None


# ---- OOM evidence ---------------------------------------------------------

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "OOM when allocating")


def is_oom(exc: BaseException) -> bool:
    """Heuristic device-OOM classifier: XLA surfaces allocation failure as
    XlaRuntimeError with RESOURCE_EXHAUSTED / out-of-memory text (there is
    no typed exception across backends)."""
    text = f"{type(exc).__name__}: {exc}"
    return any(m in text for m in _OOM_MARKERS)


def dump_memory_profile(dir_path: str, tag: str = "oom",
                        registry=None) -> str | None:
    """Persist the CUDA caching allocator's statistics
    (torch.cuda.memory_stats) as JSON next to the flight-recorder evidence;
    returns the path, or None when there is no device or the disk failed —
    evidence collection must never sink the failure path it documents."""
    try:
        import torch

        stats = torch.cuda.memory_stats()
        os.makedirs(dir_path, exist_ok=True)
        path = os.path.join(
            dir_path, f"hbm-{tag}-{int(time.time() * 1000)}.json")
        with open(path, "w") as f:
            json.dump(stats, f, indent=1, sort_keys=True)
    except Exception:  # noqa: BLE001
        return None
    if registry is not None:
        registry.counter("hbm_oom_dumps_total", help=OOM_DUMP_HELP).inc()
    return path

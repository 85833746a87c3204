"""The simulation sidecar: multi-tenant gRPC service over native snapshot state.

The port's copy of the reference package's sidecar/server.py: the same
service on PyTorch, with each tenant's world resident on `device` (None =
CUDA, raising without it; tests pass "cpu"). A batched dispatch runs the
tenants' lanes one after another (ops/autoscale_step.scale_up_sim_batch),
so "compiles" are growth of the kernel build cache (ops/kernels/build).

Deployment shape (SURVEY.md north star): ONE sidecar serves a FLEET of
autoscalers behind the reference's `externalgrpc` extension point. Each Go
control plane keeps its loop and cloud actuation; behind the estimator/
expander/processor seams it dials this sidecar — pushing KAD1 snapshot deltas
(decoded by the C++ codec into pinned buffers) under its tenant id and asking
for scale-up/scale-down simulations.

Multi-tenant serving (docs/SERVING.md): every tenant's world is bucketed into
a padded shape class (sidecar/shapes.py); concurrent requests coalesce in a
short admission window (sidecar/admission.py) and dispatch as ONE vmapped
device program per class (ops/autoscale_step.scale_up_sim_batch), so
simulation throughput scales with batch occupancy, not tenant count, and a
new tenant joining an existing class compiles NOTHING
(`recompiles_per_new_tenant` gauge, CI-asserted). The admission queue is
bounded — overload rejects with RESOURCE_EXHAUSTED + retry-after instead of
wedging — and fair: windows form round-robin across tenants, never FIFO
across all requests.

Transport: grpcio generic handlers speaking the rpc shape documented in
protos/simulator.proto (bytes payloads; no codegen dependency). Tenant
identity rides request metadata (wire.TENANT_ID_HEADER); no header = the
default tenant = the exact pre-multi-tenant behavior. The same Service
object also backs in-process use (tests, the Python control plane, bench).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import queue as _queue
import threading
import time as _time
import uuid
from collections import OrderedDict, deque
from dataclasses import dataclass, field

import numpy as np

from kubernetes_autoscaler_tpu_torch.events import EventSink
from kubernetes_autoscaler_tpu_torch.metrics import device
from kubernetes_autoscaler_tpu_torch.metrics import trace
from kubernetes_autoscaler_tpu_torch.metrics.metrics import (
    Registry,
    register_exposition,
    unregister_exposition,
)
from kubernetes_autoscaler_tpu_torch.metrics.phases import PHASE_BUCKETS, PhaseStats
from kubernetes_autoscaler_tpu_torch.models.cluster_state import DEFAULT_DIMS, Dims
from kubernetes_autoscaler_tpu_torch.ops.hostfetch import (
    fetch_pytree,
    suppress_counting,
    to_host,
)
from kubernetes_autoscaler_tpu_torch.sidecar import faults
from kubernetes_autoscaler_tpu_torch.sidecar.admission import (
    AdmissionQueue,
    BatchScheduler,
    Quarantined,
    QueueFull,
    SchedulerDown,
    Ticket,
    WorldValidationError,
)
from kubernetes_autoscaler_tpu_torch.sidecar.lifecycle import (
    REQUEST_PHASE_BUCKETS,
    SloBudgets,
    Stamps,
    add_lifecycle_spans,
    lifecycle_block,
)
from kubernetes_autoscaler_tpu_torch.sidecar.native_api import NativeSnapshotState
from kubernetes_autoscaler_tpu_torch.sidecar.shapes import ShapeClass, ShapeLadder, rung
from kubernetes_autoscaler_tpu_torch.replay.journal import TenantJournal
from kubernetes_autoscaler_tpu_torch.sidecar.wire import (
    BASE_VERSION_HEADER,
    RETRY_AFTER_MS_HEADER,
    SLO_BUDGET_MS_HEADER,
    TENANT_ID_HEADER,
    TRACE_ID_HEADER,
    DeltaWriter,
)

_SERVICE = "katpu.simulator.v1.TpuSimulator"

# node-group template count quantization (requests carry their own template
# ladder; NG is small, so a fine-grained geometric base keeps padding waste low)
_NG_RUNG_BASE = 4


def _fetch_serial(tree):
    """A serial sim's outputs home in one packed fetch (a CUDA tensor never
    goes through np.asarray). Uncounted, as the reference's np.asarray reads
    are: the loop's round-trip meter sees only the batched fetches."""
    with suppress_counting():
        return fetch_pytree(tree)


def _verdicts(down):
    """The ScaleDownSim fields a response reads: the drain sweep's per-pod
    planes (C x max_pods_per_node) stay on the device."""
    return down.replace(removal=down.removal.replace(
        has_blocker=None, n_moved=None, n_failed=None, dest_node=None,
        pod_slot=None, feas=None))


@dataclass
class SimParams:
    max_new_nodes: int = 256
    strategy: str = "least-waste"
    threshold: float = 0.5
    node_groups: list | None = None


@dataclass
class _Tenant:
    """One tenant's server-resident world + caches."""

    tid: str
    state: NativeSnapshotState
    aux: dict = field(default_factory=dict)
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    shape_class: ShapeClass | None = None
    # plane-granular export caches (ISSUE 11): keyed PER SECTION by the
    # codec's section version + the class axis rung — a single-pod delta
    # bumps only the sections its ops touched, so untouched planes are
    # never re-materialized (numpy) or re-uploaded (device). The device
    # tier is the tenant's RESIDENT world: steady windows stack these
    # arrays on-device and move zero world h2d bytes.
    export_keys: dict = field(default_factory=dict)  # section -> (sv, rung)
    export_np: dict = field(default_factory=dict)    # section -> numpy dict
    dev_keys: dict = field(default_factory=dict)     # section -> (sv, rung)
    dev_np: dict = field(default_factory=dict)       # section -> device dict
    # serial-path residency: version-keyed cache of the fully-assembled
    # (tensors + constraint overlay) world, so constrained/serial tenants
    # stop re-uploading per RPC too
    serial_cache: tuple | None = None
    # encode-mode accounting mirrored per tenant for Statusz
    encode_modes: dict = field(default_factory=dict)
    # request node-group digest -> (ng numpy tensors, ids, ng_rung, digest)
    ng_cache: OrderedDict = field(default_factory=OrderedDict)
    dispatched: bool = False     # has served ≥1 sim (new-tenant accounting)
    # serving observability: recent e2e latencies (statusz percentiles),
    # SLO breach count and the last breach's retained exemplar trace id
    lat_ms: deque = field(default_factory=lambda: deque(maxlen=512))
    slo_breaches: int = 0
    last_breach_trace: str = ""
    # per-tenant flight journal (replay/journal.TenantJournal): bounded
    # in-memory provenance ring, persisted on breach/backpressure
    journal: TenantJournal | None = None
    # pre-admission validation cache: the section-version tuple the last
    # clean validation ran against (unchanged sections re-validate free)
    validated_key: tuple | None = None
    # warm restart (docs/ROBUSTNESS.md): True while serving from a
    # checkpoint-restored export (native codec state still empty); the
    # first ApplyDelta full-resend exits rehydration
    rehydrated: bool = False
    rehydrated_meta: dict | None = None


class SimulatorService:
    """Transport-independent service core (multi-tenant)."""

    def __init__(self, dims: Dims = DEFAULT_DIMS,
                 node_bucket: int = 256, group_bucket: int = 64,
                 pod_bucket: int = 256,
                 batch_lanes: int = 0, batch_window_ms: float = 2.0,
                 batch_window_max: int | None = None,
                 queue_depth: int = 128, ticket_timeout_s: float = 60.0,
                 max_tenants: int = 256,
                 slo_default_budget_ms: float = 0.0,
                 slo_budgets: dict | None = None,
                 slo_dump_dir: str = "",
                 tail_sample_capacity: int = 64,
                 tail_slow_quantile: float = 0.95,
                 journal_capacity: int = 256,
                 quarantine_ttl_s: float = 30.0,
                 max_world: tuple | None = None,
                 rehydrate_dir: str = "",
                 hbm_budget_frac: float = 0.0,
                 hbm_limit_bytes: int = 0,
                 device_profile_dir: str = "",
                 profile_min_interval_s: float = 30.0,
                 profile_max_captures: int = 8,
                 shadow_audit: bool = False,
                 device=None):
        from kubernetes_autoscaler_tpu_torch.device import resolve_device

        # where every tenant's resident world and every sim runs; below,
        # `device` names the metrics module again, as everywhere in this file
        self.device = resolve_device(device)
        from kubernetes_autoscaler_tpu_torch.metrics import device

        self.dims = dims
        self.max_tenants = int(max_tenants)
        # fault-domain isolation (docs/ROBUSTNESS.md): quarantine TTL and
        # the structural world caps the pre-admission validator enforces
        # ((nodes, groups, pods); defaults are generous — they bound abuse,
        # not legitimate scale)
        self.quarantine_ttl_s = float(quarantine_ttl_s)
        self.max_world = tuple(max_world) if max_world \
            else (1 << 20, 1 << 16, 1 << 21)
        self._quarantine: dict[str, dict] = {}
        self._quarantine_lock = threading.Lock()
        self._not_serving = ""      # non-empty = Health reports NOT_SERVING
        self.node_bucket = node_bucket
        self.group_bucket = group_bucket
        self.pod_bucket = pod_bucket
        # per-RPC metrics, exposed in prometheus text by the Metricz rpc
        # (the sidecar's /metricz analog — it has no HTTP mux of its own).
        # Registered with the process /metrics exposition too, so an
        # in-process sidecar's series appear identically on both surfaces.
        self.registry = Registry(prefix="katpu_sidecar")
        register_exposition(self.registry)
        # device-side observability (metrics/device.py): the HBM residency
        # ledger (owner/tenant-tagged census of the resident device arrays —
        # tenant export tiers, stack cache, world-store planes), the compile
        # census (which shape signature compiled for which tenant, at what
        # flop/temp-HBM cost), and the breach-armed device profiler.
        # `hbm_budget_frac` > 0 turns residency into an ADMISSION dimension:
        # a new tenant whose projected class-shaped residency would push
        # tagged bytes past frac·limit is rejected with the `hbm-budget`
        # validation reason instead of OOMing the window it joined.
        device.enable_ledger()
        self.hbm_budget_frac = float(hbm_budget_frac)
        self.hbm_limit_bytes = int(hbm_limit_bytes)
        self._hbm_limit_cache: int | None = None
        # async analysis: the mode-"full" AOT compile for memory figures
        # must not run inside the dispatch that just paid a real compile
        self.census = device.CompileCensus(registry=self.registry)
        if device_profile_dir:
            device.install_profiler(
                device_profile_dir,
                min_interval_s=profile_min_interval_s,
                max_captures=profile_max_captures,
                registry=self.registry)
        # activate a chaos plan declared in the environment (KATPU_FAULTS);
        # a programmatically installed plan wins, absence costs one env
        # read. The registry rides as the plan's default so hook sites
        # WITHOUT a handle (batch.py / admission.py) still count their
        # fires into faults_injected_total — the "stamped 3 ways" contract
        faults.from_env(registry=self.registry)
        self.phases = PhaseStats(owner="sidecar", registry=self.registry)
        self.ladder = ShapeLadder(node_bucket, group_bucket, pod_bucket,
                                  registry=self.registry)
        # serving-grade observability (docs/OBSERVABILITY.md "Serving
        # surfaces"): per-tenant latency budgets, tail-sampled request
        # traces with exemplar linkage, admission-reject events
        self.slo = SloBudgets(slo_default_budget_ms, slo_budgets)
        self.slo_dump_dir = slo_dump_dir
        self.tail = trace.TailSampler(capacity=tail_sample_capacity,
                                      slow_quantile=tail_slow_quantile)
        # per-tenant journal ring size; the tenant table cap bounds how many
        # rings exist, this bounds each ring's records
        self.journal_capacity = int(journal_capacity)
        self.events = EventSink(registry=self.registry)
        self._events_lock = threading.Lock()   # EventSink isn't thread-safe
        self._tenants: dict[str, _Tenant] = {}
        self._tenants_lock = threading.Lock()
        # serializes the (cache-size, dispatch, cache-size) window that
        # charges recompiles_per_new_tenant: the jit caches are process
        # global, so a concurrent dispatch on another thread (scheduler vs
        # a constrained tenant's serial handler) would otherwise have its
        # compiles attributed to whichever tenant measured last
        self._account_lock = threading.Lock()
        self._tenant("")     # the default tenant: pre-multi-tenant behavior
        # ---- batching (0 lanes = serial dispatch per RPC, the legacy path)
        self.batch_lanes = int(batch_lanes)
        self.ticket_timeout_s = ticket_timeout_s
        self.occupancies: deque[int] = deque(maxlen=1024)
        self._queue: AdmissionQueue | None = None
        self._scheduler: BatchScheduler | None = None
        # device-utilization accounting: recent (gap_seconds, cause) pairs
        # from the scheduler's dispatch-gap estimator (bench percentiles)
        self.gaps: deque[tuple] = deque(maxlen=4096)
        if self.batch_lanes > 0:
            from kubernetes_autoscaler_tpu_torch.sidecar.batch import StackCache

            self._stack_cache = StackCache()
            self._queue = AdmissionQueue(
                max_depth=queue_depth,
                retry_after_ms=max(int(batch_window_ms * 10), 20))
            self._scheduler = BatchScheduler(
                self._queue, self._dispatch_batch, lanes=self.batch_lanes,
                window_s=batch_window_ms / 1000.0,
                window_max=batch_window_max,
                gap_cb=self._note_gap,
                on_batch_failure=self._batch_failure,
                on_crash=self._scheduler_crash).start()
        # online shadow audit, serving edition (docs/OBSERVABILITY.md
        # "Shadow audit"): one ROUND-ROBIN member lane per batched window
        # is re-simulated through the serial (unbatched) reference program
        # and its assembled response compared bit-for-bit — the online form
        # of test_batched_sim's serial≡batched identity. A divergence is a
        # DEVICE/BACKEND fault by construction (same inputs, independent
        # executable), so it rides the supervisor/backend evidence path —
        # counter + AuditDivergence event + tail-retained trace
        # (reason=audit) + tenant-journal persist — and NEVER convicts the
        # tenant (contrast: PR 12's poison-member quarantine, which fires
        # on per-member validation/NaN faults, i.e. BAD INPUTS).
        self.shadow_audit = bool(shadow_audit)
        self._audit_rr = 0
        self.audit_divergences = 0
        self.audit_last: dict | None = None
        self.audit_overhead_ns = 0
        # the audit runs on its OWN worker, never the scheduler thread:
        # the reference re-sim (and its first-window compile, seconds)
        # must not stall the next coalescing window's dispatch. Bounded
        # queue; a full queue drops the window's audit (counted skipped).
        self._audit_q: "_queue.Queue | None" = None
        self._audit_stop = threading.Event()
        self._audit_worker: threading.Thread | None = None
        # batch-compat keys whose serial reference variant has already
        # compiled: later audits at the key dispatch lock-free
        self._audit_warmed: set = set()
        if self.shadow_audit:
            self._audit_q = _queue.Queue(maxsize=4)
            self._audit_worker = threading.Thread(
                target=self._audit_loop, daemon=True, name="ka-shadow-audit")
            self._audit_worker.start()
        # warm restart: rehydrate per-tenant serving records persisted by
        # checkpoint() — steady tenants serve batched sims again without a
        # full world re-send (docs/ROBUSTNESS.md)
        self.rehydration = {"restored": 0, "digest_mismatch": 0, "error": 0}
        if rehydrate_dir:
            self._rehydrate(rehydrate_dir)

    def close(self) -> None:
        if self._scheduler is not None:
            self._scheduler.stop()
            self._scheduler = None
        if self._audit_worker is not None:
            self._audit_stop.set()
            self._audit_worker.join(timeout=2.0)
            self._audit_worker = None
        unregister_exposition(self.registry)

    def _note_gap(self, gap_s: float, cause: str) -> None:
        """Dispatch-gap accounting (BatchScheduler.gap_cb): `pipelined` and
        `stall` gaps measure device idle while work existed — the pipelining
        contract says their distribution sits at ≈0; `idle` gaps are
        arrival-bound and ride a separate counter so an idle fleet does not
        read as a pipeline failure."""
        self.gaps.append((gap_s, cause))
        if cause == "idle":
            self.registry.counter(
                "device_idle_seconds_total",
                help="Device idle while the admission queue was empty "
                     "(arrival-bound, not a pipeline stall)").inc(gap_s)
            return
        self.registry.histogram(
            "dispatch_gap_seconds",
            help="Estimated device idle between one batch's results being "
                 "ready and the next dispatch launching, while work "
                 "existed — ≈0 under pipelining (CI-asserted)",
            buckets=REQUEST_PHASE_BUCKETS).observe(gap_s, cause=cause)

    # ---- tenants ----

    def _tenant(self, tid: str) -> _Tenant:
        with self._tenants_lock:
            ts = self._tenants.get(tid)
            if ts is None:
                if len(self._tenants) >= self.max_tenants:
                    # tenant ids arrive on unauthenticated request metadata:
                    # without a cap, a client stamping fresh ids allocates
                    # one world each until OOM. RESOURCE_EXHAUSTED, like the
                    # admission bound — the operator frees slots with
                    # drop_tenant (or runs a bigger sidecar).
                    e = QueueFull(None, retry_after_ms=1000,
                                  what=f"tenant table "
                                       f"({self.max_tenants} worlds)",
                                  reason="tenant-cap")
                    self._note_reject(tid, e)
                    raise e
                ts = _Tenant(tid=tid, state=NativeSnapshotState(self.dims))
                ts.journal = TenantJournal(tenant=tid,
                                           capacity=self.journal_capacity,
                                           registry=self.registry)
                self._tenants[tid] = ts
                self.registry.gauge(
                    "tenants_active",
                    help="Tenant worlds resident in this sidecar",
                ).set(float(len(self._tenants)))
            return ts

    def _tenant_peek(self, tid: str) -> "_Tenant | None":
        """Read-only lookup: never allocates a world (observability paths
        must not mint tenants from a stray metadata header)."""
        with self._tenants_lock:
            return self._tenants.get(tid)

    def drop_tenant(self, tid: str) -> bool:
        """Evict a tenant's world and ZERO its labelled series (the
        stale-label convention: a dropped tenant must not keep claiming
        traffic — or classification history, phase time, or SLO breaches —
        in the exposition)."""
        with self._tenants_lock:
            ts = self._tenants.pop(tid, None)
            self.registry.gauge("tenants_active").set(
                float(len(self._tenants)))
        if ts is None:
            return False
        self.registry.counter("rpc_total").zero_matching(tenant=tid)
        self.registry.histogram(
            "rpc_duration_seconds").zero_matching(tenant=tid)
        # the same sweep for every tenant-labelled family the serving layer
        # grew: shape-class classification history (ISSUE 8 fix — these
        # lingered forever before), lifecycle phase histograms, SLO breaches
        self.registry.counter("shape_class_hit_total").zero_matching(
            tenant=tid)
        self.registry.counter("shape_class_miss_total").zero_matching(
            tenant=tid)
        self._phase_hist().zero_matching(tenant=tid)
        self.registry.counter("tenant_slo_breaches_total").zero_matching(
            tenant=tid)
        # world-store families are tenant-labelled too: a dropped tenant's
        # resident lanes died with the _Tenant object, so its encode-mode
        # history and h2d byte series must not linger in the exposition
        self.registry.counter("encoder_encodes_total").zero_matching(
            tenant=tid)
        self.registry.counter("world_store_h2d_bytes_total").zero_matching(
            tenant=tid)
        # device-residency families: the tenant's resident lanes die with
        # the _Tenant object, so its HBM gauges zero NOW (not at the next
        # ledger reconcile) and its census charge attribution is removed —
        # the same zero_matching contract as the serving families above
        self.registry.gauge("tenant_hbm_bytes").zero_matching(tenant=tid)
        self.registry.gauge("resident_bytes").zero_matching(tenant=tid)
        self.registry.counter("compile_census_total").zero_matching(
            tenant=tid)
        self.census.zero_tenant(tid)
        if device.LEDGER is not None:
            # owner-scoped: tenant="" is also how the NON-tenant owners
            # (world_store / stack_cache / marshal) are tagged — dropping
            # the default tenant must not deflate their census
            device.LEDGER.release(owner="tenant_export", tenant=tid)
        # per-tenant shadow-audit families: the audited lanes died with the
        # tenant; its check/divergence series must not linger either
        self.registry.counter("shadow_audit_checks_total").zero_matching(
            tenant=tid)
        # journal families are tenant-labelled too (TenantJournal); its ring
        # died with the _Tenant object, so its series must zero as well
        jt = tid or "default"
        self.registry.counter("journal_records_total").zero_matching(
            tenant=jt)
        self.registry.counter("journal_bytes_total").zero_matching(tenant=jt)
        self.registry.counter("journal_dropped_total").zero_matching(
            tenant=jt)
        self.slo.drop(tid)
        return True

    def tenants(self) -> list[str]:
        with self._tenants_lock:
            return sorted(self._tenants)

    # ---- fault-domain isolation (docs/ROBUSTNESS.md) ----

    def _check_quarantine(self, tenant: str) -> None:
        """Admission edge: a quarantined tenant's sims are rejected with
        FAILED_PRECONDITION until its TTL elapses (auto-parole — the first
        request after the TTL is admitted and the entry cleared)."""
        with self._quarantine_lock:
            q = self._quarantine.get(tenant)
            if q is None:
                return
            now = _time.monotonic()
            if now < q["until"]:
                raise Quarantined(tenant, q["reason"],
                                  retry_after_ms=max(
                                      int((q["until"] - now) * 1000), 1))
            del self._quarantine[tenant]
        self._note_parole(tenant, "ttl")

    def _note_parole(self, tenant: str, how: str) -> None:
        self.registry.counter(
            "tenant_paroled_total",
            help="Quarantined tenants re-admitted, by parole path (ttl = "
                 "sentence elapsed; new-world = the tenant re-sent its "
                 "world via ApplyDelta)").inc(how=how)
        with self._events_lock:
            self.events.emit("QuarantineParole", tenant or "default", how,
                             now=_time.time())

    def _quarantine_tenant(self, tenant: str, reason: str,
                           error: Exception | None = None) -> None:
        """Isolate the offender: further sims reject until the TTL parole
        (or an ApplyDelta re-send). Counted per reason, evidenced on the
        event sink and the Statusz quarantine table."""
        now = _time.monotonic()
        with self._quarantine_lock:
            q = self._quarantine.get(tenant)
            if q is None:
                q = self._quarantine[tenant] = {
                    "since": _time.time(), "count": 0}
            q["count"] += 1
            q["reason"] = reason
            q["until"] = now + self.quarantine_ttl_s
            q["error"] = repr(error) if error is not None else ""
        self.registry.counter(
            "tenant_quarantined_total",
            help="Tenants quarantined after a window failure bisected down "
                 "to them, by fault reason").inc(reason=reason)
        with self._events_lock:
            self.events.emit("TenantQuarantined", tenant or "default",
                             reason, message=repr(error) if error else "",
                             now=_time.time())

    def _parole_on_new_world(self, tenant: str) -> None:
        """A successful ApplyDelta paroles early: the quarantined world was
        the evidence, and the tenant just replaced it."""
        with self._quarantine_lock:
            if self._quarantine.pop(tenant, None) is None:
                return
        self._note_parole(tenant, "new-world")

    def quarantine_stats(self) -> dict:
        """tenant -> {reason, count, remaining_s, since} (statusz/bench)."""
        now = _time.monotonic()
        with self._quarantine_lock:
            return {
                t or "default": {
                    "reason": q["reason"], "count": q["count"],
                    "since": q["since"],
                    "remaining_s": round(max(q["until"] - now, 0.0), 3),
                    "error": q["error"],
                }
                for t, q in self._quarantine.items()}

    @staticmethod
    def _fault_reason(error: Exception) -> str:
        if isinstance(error, faults.InjectedFault):
            return f"injected-{error.hook}"
        from kubernetes_autoscaler_tpu_torch.sidecar.batch import MemberFault

        if isinstance(error, MemberFault):
            return "poison-result"
        return f"window-{type(error).__name__}"

    def _batch_failure(self, tickets: list[Ticket], error: Exception) -> None:
        """Entry point for a FAILED window batch (BatchScheduler
        .on_batch_failure / InFlightBatch.on_failure): start a bounded
        bisection re-dispatch. The budget caps TOTAL re-dispatches for the
        whole failure tree — a genuine device/infra failure (every half
        keeps failing) degrades the window with per-member errors instead
        of looping, while a single poison member costs ~2·log2(B)
        re-dispatches to isolate."""
        budget = [max(4, 2 * max(len(tickets), 1).bit_length() + 2)]
        self.registry.counter(
            "window_failures_total",
            help="Batched dispatch windows that failed at dispatch or "
                 "harvest and entered bisection re-dispatch").inc()
        if device.is_oom(error) and self.slo_dump_dir:
            # a device OOM is an allocator post-mortem, not a poison world:
            # persist the per-allocation pprof snapshot BEFORE bisection
            # churns the heap, next to the SLO/backpressure evidence
            path = device.dump_memory_profile(
                self.slo_dump_dir, tag="window-oom", registry=self.registry)
            if path:
                with self._events_lock:
                    self.events.emit("HbmOomDump", "sidecar", "window-oom",
                                     message=path, now=_time.time())
        self._bisect(tickets, error, budget)

    def _bisect(self, tickets: list[Ticket], error: Exception,
                budget: list[int], tried: set | None = None) -> None:
        tried = tried if tried is not None else set()
        live = [t for t in tickets if not t.done.is_set()]
        if not live:
            return
        if len(live) == 1:
            t = live[0]
            if id(t) not in tried and budget[0] > 0:
                # one retry before conviction: a singleton that failed may
                # have hit a TRANSIENT fault, not be poison — multi-member
                # windows implicitly get this via their half re-dispatches,
                # a lone member (low traffic, lanes=1) must get it too
                tried.add(id(t))
                budget[0] -= 1
                self.registry.counter("window_redispatches_total").inc()
                try:
                    inflight = self._dispatch_batch(
                        live, bisect_budget=budget, bisect_tried=tried)
                except Exception as e:  # noqa: BLE001 — recurse: now convict
                    self._bisect(live, e, budget, tried)
                    return
                inflight.harvest()
                return
            # isolated AND retried: the poison member. Quarantine + error
            # THIS ticket; every healthy co-member was already served
            # bit-identically by its own half re-dispatch (vmap lanes are
            # independent).
            self._quarantine_tenant(t.tenant, self._fault_reason(error),
                                    error=error)
            t.resolve(error=error)
            return
        if budget[0] <= 0:
            self.registry.counter(
                "bisect_budget_exhausted_total",
                help="Bisection re-dispatch trees cut short by the retry "
                     "budget (a whole-device/infra failure pattern, not a "
                     "poison member) — remaining members degrade with "
                     "per-member errors").inc()
            for t in live:
                t.resolve(error=error)
            return
        mid = (len(live) + 1) // 2
        for half in (live[:mid], live[mid:]):
            budget[0] -= 1
            self.registry.counter(
                "window_redispatches_total",
                help="Half-window re-dispatches issued by bisection").inc()
            try:
                inflight = self._dispatch_batch(half, bisect_budget=budget,
                                                bisect_tried=tried)
            except Exception as e:  # noqa: BLE001 — recurse on this half
                self._bisect(half, e, budget, tried)
                continue
            # synchronous harvest: the failure path trades the pipeline
            # overlap for bounded isolation latency; a harvest failure
            # recurses through the InFlightBatch's on_failure (same budget)
            inflight.harvest()

    def _scheduler_crash(self, error: Exception) -> None:
        """Supervision escalation (BatchScheduler.on_crash): the dispatch
        thread died, so the serving path is gone — flip Health to
        NOT_SERVING (orchestration restarts the sidecar) and leave the
        evidence on metrics + events. Queued tickets were already failed
        and the admission queue closed by the scheduler's crash handler."""
        self._not_serving = f"batch scheduler crashed: {error!r}"
        self.registry.counter(
            "scheduler_crashes_total",
            help="Batch-scheduler serve-loop deaths (Health flips to "
                 "NOT_SERVING; queued tickets failed fast)").inc()
        with self._events_lock:
            self.events.emit("SchedulerCrash", "sidecar",
                             type(error).__name__, message=str(error),
                             now=_time.time())

    # ---- pre-admission validation (docs/ROBUSTNESS.md) ----

    def _note_validation_reject(self, tenant: str,
                                e: WorldValidationError) -> None:
        self.registry.counter(
            "world_validation_rejects_total",
            help="Requests rejected INVALID_ARGUMENT by pre-admission "
                 "world/param validation, by taxonomy reason",
        ).inc(reason=e.reason)
        with self._events_lock:
            self.events.emit("WorldValidationReject", tenant or "default",
                             e.reason, message=str(e), now=_time.time())

    def _validate_params(self, params: SimParams, kind: str) -> None:
        """Request-side structural screen (cheap scalar checks, every
        request): NaN/inf and negative values in the simulation parameters
        — a NaN threshold or template capacity would poison every lane of
        the window it joined."""
        import math

        def _bad_float(v) -> bool:
            return isinstance(v, float) and not math.isfinite(v)

        if kind == "down":
            th = params.threshold
            if not isinstance(th, (int, float)) or _bad_float(float(th)):
                raise WorldValidationError("nan", f"threshold={th!r}")
            if th < 0:
                raise WorldValidationError("negative-request",
                                           f"threshold={th!r}")
            return
        if params.max_new_nodes < 0:
            raise WorldValidationError(
                "negative-request", f"max_new_nodes={params.max_new_nodes}")
        for g in params.node_groups or []:
            tpl = (g or {}).get("template") or {}
            for field_name in ("capacity", "allocatable"):
                for k, v in (tpl.get(field_name) or {}).items():
                    if _bad_float(v):
                        raise WorldValidationError(
                            "nan", f"node group {g.get('id')!r}: "
                                   f"{field_name}[{k}]={v}")
                    if isinstance(v, (int, float)) and v < 0:
                        raise WorldValidationError(
                            "negative-request",
                            f"node group {g.get('id')!r}: "
                            f"{field_name}[{k}]={v}")

    def _validate_world(self, ts: _Tenant) -> None:
        """World-side structural screen, run BEFORE the world reaches a
        coalescing window; caller holds ts.lock. Cached per section-version
        tuple, so steady tenants re-validate for one tuple compare — the
        scan only runs when a delta actually changed a section. Rehydrated
        tenants were validated before their checkpoint."""
        if ts.rehydrated:
            return
        n, p, g = ts.state.counts()
        mn, mg, mp = self.max_world
        if n > mn or g > mg or p > mp:
            raise WorldValidationError(
                "oversize-world",
                f"counts nodes={n} groups={g} pods={p} exceed caps "
                f"nodes={mn} groups={mg} pods={mp}")
        key = ts.state.section_versions()
        if ts.validated_key == key:
            return
        groups_np = ts.export_np.get("groups")
        pods_np = ts.export_np.get("pods")
        for section, arr in (("groups", groups_np), ("pods", pods_np)):
            if arr is not None and int(arr["req"].min(initial=0)) < 0:
                raise WorldValidationError(
                    "negative-request",
                    f"{section} section carries a negative resource "
                    f"request (min={int(arr['req'].min())})")
        ts.validated_key = key

    # ---- HBM budget admission (docs/OBSERVABILITY.md "Device surfaces") ----

    def _hbm_limit(self) -> int:
        """The budget denominator: the configured override, else the
        device's own bytes_limit (probed once — memory_stats is a device
        call). 0 = unknown (CPU floor without an override) = budget off."""
        if self.hbm_limit_bytes:
            return self.hbm_limit_bytes
        if self._hbm_limit_cache is None:
            # the card's memory, and none for a service on the CPU
            ms = (device.memory_stats() if self.device.type == "cuda"
                  else None)
            self._hbm_limit_cache = int((ms or {}).get("bytes_limit") or 0)
        return self._hbm_limit_cache

    def _check_hbm_budget(self, ts: _Tenant) -> None:
        """Projected-residency admission gate; caller holds ts.lock with
        export_np fresh at class shape. A tenant whose lanes are already
        resident at the current keys re-admits free (steady path: two dict
        probes); a tenant about to upload projects its class-shaped export
        bytes on top of everyone else's live tagged bytes and is rejected
        with the `hbm-budget` validation reason when the total would breach
        frac·limit — a loud structured reject instead of an OOM that would
        take the whole coalescing window (and its innocent co-tenants)
        down."""
        if self.hbm_budget_frac <= 0 or device.LEDGER is None:
            return
        if ts.dev_keys and all(
                ts.dev_keys.get(s) == ts.export_keys.get(s)
                for s in ("nodes", "groups", "pods")):
            return      # resident at current keys: nothing new to admit
        limit = self._hbm_limit()
        if limit <= 0:
            return      # no denominator (CPU floor, no override): gate off
        projected = sum(
            int(v.nbytes)
            for s in ("nodes", "groups", "pods")
            for v in ts.export_np.get(s, {}).values())
        self._hbm_budget_screen(ts.tid, projected, limit)

    def _hbm_budget_screen(self, tid: str, projected: int,
                           limit: int) -> None:
        """The shared core: reject when `projected` bytes for `tid` on top
        of everyone ELSE's live tagged bytes would breach frac·limit."""
        own = device.LEDGER.tenant_bytes(tid)
        others = device.LEDGER.tagged_bytes() - own
        budget = self.hbm_budget_frac * limit
        if others + projected > budget:
            raise WorldValidationError(
                "hbm-budget",
                f"projected residency {projected}b for tenant "
                f"{tid or 'default'!r} on top of {others}b already "
                f"tagged would breach the HBM budget "
                f"({self.hbm_budget_frac:.2f} x {limit}b = {budget:.0f}b)")

    # ---- warm restart: checkpoint + rehydration (docs/ROBUSTNESS.md) ----

    @staticmethod
    def _export_digest(arrays: dict) -> str:
        """Canonical digest over a tenant's class-shaped export planes:
        name, dtype, shape and raw bytes of every section field in sorted
        order — the journal-style content digest a rehydrating sidecar
        verifies before trusting a record."""
        h = hashlib.sha256()
        for name in sorted(arrays):
            a = np.ascontiguousarray(arrays[name])
            h.update(name.encode())
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        return h.hexdigest()[:16]

    def checkpoint(self, dir_path: str) -> dict:
        """Persist per-tenant rehydration records (graceful shutdown /
        periodic checkpoint): class-shaped native export planes + metadata
        (world version, section versions, shape class, SLO budget, journal
        cursor, content digest). A restarted sidecar pointed at the same
        directory serves these tenants' batched sims again WITHOUT a full
        world re-send; constrained (aux-overlay) and empty tenants are
        skipped — they fall back to the existing full-encode re-send path."""
        import os

        os.makedirs(dir_path, exist_ok=True)
        written = []
        for tid in self.tenants():
            ts = self._tenant_peek(tid)
            if ts is None:
                continue
            with ts.lock:
                if ts.aux:
                    continue    # constrained tier: needs the native world
                if ts.state.version == 0 and not ts.rehydrated:
                    continue    # empty world: nothing to restore
                if not ts.rehydrated:
                    self._export_np(ts)     # refresh sections at class shape
                if np.any(ts.export_np["nodes"]["zone_id"] > 0):
                    # zoned worlds restart cold by design: the codec's
                    # zone-id interning is not recoverable from the export
                    # planes, and a rehydrated tenant's templates would be
                    # lowered against a FRESH id space — silently wrong
                    # multi-zone sims instead of a re-send
                    continue
                arrays = {f"{sec}:{k}": v
                          for sec in ("nodes", "groups", "pods")
                          for k, v in ts.export_np[sec].items()}
                n, p, g = (tuple(ts.rehydrated_meta["counts"])
                           if ts.rehydrated else ts.state.counts())
                cursor = (ts.journal.cursor()
                          if ts.journal is not None else None)
                meta = {
                    "tenant": tid,
                    "version": (ts.rehydrated_meta["version"]
                                if ts.rehydrated else ts.state.version),
                    "counts": [n, p, g],
                    "sections": {s: list(ts.export_keys[s])
                                 for s in ("nodes", "groups", "pods")},
                    "shape_class": ts.shape_class.key if ts.shape_class
                    else "",
                    "slo_budget_ms": self.slo.get(tid) or 0.0,
                    "journal_cursor": list(cursor) if cursor else None,
                    "digest": self._export_digest(arrays),
                }
            fname = ("rehydrate-"
                     + hashlib.sha1((tid or "default").encode())
                     .hexdigest()[:12] + ".npz")
            path = os.path.join(dir_path, fname)
            tmp = path + ".tmp.npz"
            with open(tmp, "wb") as f:
                np.savez(f, __meta__=np.frombuffer(
                    json.dumps(meta).encode(), dtype=np.uint8), **arrays)
            os.replace(tmp, path)
            written.append(tid)
        return {"dir": dir_path, "tenants": len(written), "ids": written}

    def _rehydrated_total(self):
        """The one accessor for `tenant_rehydrated_total` — whichever
        outcome fires first creates the family with its help text (the
        _phase_hist convention)."""
        return self.registry.counter(
            "tenant_rehydrated_total",
            help="Warm-restart rehydration outcomes per checkpoint record "
                 "(restored / digest-mismatch / error)")

    def _rehydrate(self, dir_path: str) -> None:
        """Load rehydration records written by checkpoint(). Every record
        is digest-verified before its planes are trusted; a mismatch (torn
        write, tampering, version skew) drops the record — that tenant is
        simply cold and re-sends its world like any new tenant."""
        import glob
        import os

        for path in sorted(glob.glob(os.path.join(dir_path,
                                                  "rehydrate-*.npz"))):
            try:
                with np.load(path) as z:
                    meta = json.loads(bytes(z["__meta__"].tobytes()))
                    arrays = {k: z[k] for k in z.files if k != "__meta__"}
                if self._export_digest(arrays) != meta["digest"]:
                    self.rehydration["digest_mismatch"] += 1
                    self._rehydrated_total().inc(outcome="digest-mismatch")
                    continue
                tid = meta["tenant"]
                ts = self._tenant(tid)
                with ts.lock:
                    ts.export_np = {"nodes": {}, "groups": {}, "pods": {}}
                    for k, v in arrays.items():
                        sec, field_name = k.split(":", 1)
                        ts.export_np[sec][field_name] = v
                    ts.export_keys = {s: tuple(v) for s, v in
                                      meta["sections"].items()}
                    ts.rehydrated = True
                    ts.rehydrated_meta = {"version": meta["version"],
                                          "counts": meta["counts"],
                                          "digest": meta["digest"]}
                    n, p, g = meta["counts"]
                    ts.shape_class = self.ladder.classify(n, g, p,
                                                          tenant=tid)
                    if meta.get("slo_budget_ms"):
                        self.slo.set(tid, float(meta["slo_budget_ms"]))
                    if ts.journal is not None:
                        ts.journal.record("rehydrate", meta["version"],
                                          digest=meta["digest"])
                self.rehydration["restored"] += 1
                self._rehydrated_total().inc(outcome="restored")
            except Exception:  # noqa: BLE001 — a bad record = a cold tenant
                self.rehydration["error"] += 1
                self._rehydrated_total().inc(outcome="error")

    def _exit_rehydration(self, ts: _Tenant) -> None:
        """First ApplyDelta after a warm restart: the native codec state is
        authoritative again — drop the restored planes and every cache
        keyed by the OLD process's section versions. Caller holds ts.lock."""
        ts.rehydrated = False
        ts.rehydrated_meta = None
        ts.export_keys = {}
        ts.export_np = {}
        ts.dev_keys = {}
        ts.dev_np = {}
        ts.serial_cache = None
        ts.validated_key = None

    # legacy single-tenant accessors (tests, conformance tooling)
    @property
    def state(self) -> NativeSnapshotState:
        return self._tenant("").state

    @property
    def _aux(self) -> dict:
        return self._tenant("").aux

    # ---- rpc: ApplyDelta ----

    def apply_delta(self, payload: bytes, tenant: str = "",
                    base_version: int | None = None) -> dict:
        from kubernetes_autoscaler_tpu_torch.sidecar.wire import split_aux

        ts = self._tenant(tenant)
        with ts.lock:
            # snapshot-version pinning (wire.BASE_VERSION_HEADER): a delta
            # built against a version the server does not hold — most
            # importantly after a restart, when the codec is empty or the
            # tenant is serving a rehydrated export — must reject loudly
            # (INVALID_ARGUMENT, reason pinned by tests) instead of
            # silently applying against the wrong base snapshot
            if base_version is not None \
                    and int(base_version) != ts.state.version:
                e = WorldValidationError(
                    "section-version-mismatch",
                    f"delta built against version {base_version}, server "
                    f"holds {ts.state.version}"
                    + (" (rehydrated world — full re-send required)"
                       if ts.rehydrated else ""))
                self._note_validation_reject(tenant, e)
                raise e
            try:
                if faults.PLAN is not None:
                    payload = faults.PLAN.fire(
                        "codec_decode", tenant=tenant, payload=payload,
                        registry=self.registry)
                # split INSIDE the guarded region: any malformed trailer must
                # surface as an error dict, never an uncaught exception
                dense, aux = split_aux(payload)
                ts.state.apply_delta(dense)
                if ts.rehydrated:
                    # the codec state is authoritative again: drop the
                    # restored planes + the old process's cache keys
                    self._exit_rehydration(ts)
                if aux is not None:
                    ts.aux.update(aux.get("up", {}))
                    for uid in aux.get("del", []):
                        ts.aux.pop(uid, None)
                self._classify(ts)
                # provenance: the KAD1 payload IS the tenant's world delta —
                # journal its digest against the post-apply version
                if ts.journal is not None:
                    ts.journal.record(
                        "delta", ts.state.version, nbytes=len(payload),
                        digest=hashlib.sha256(payload).hexdigest()[:16])
                # the ack version is read UNDER ts.lock: a concurrent delta
                # for this tenant must not make the ack report a version
                # whose contents this caller never sent (clients pin
                # BASE_VERSION_HEADER from exactly this value)
                acked_version = ts.state.version
            except (ValueError, TypeError) as e:
                # codec rejections ride the error-dict contract (committed
                # goldens / Go shim compatibility) but still count into the
                # validation taxonomy — a chaos-truncated section lands here
                self._note_validation_reject(
                    tenant, WorldValidationError("codec", str(e)))
                return {"version": ts.state.version, "error": str(e)}
        # a successful re-send paroles a quarantined tenant early: the
        # quarantined world is gone, the tenant brought a new one
        self._parole_on_new_world(tenant)
        return {"version": acked_version, "error": ""}

    def _classify(self, ts: _Tenant) -> ShapeClass:
        """(Re)bucket a tenant's world; caller holds ts.lock. Counts within
        the current rungs keep the class — the hit counters measure exactly
        the "no new padded shape" guarantee."""
        if ts.rehydrated:
            # the class was restored (and re-seen on the ladder) at
            # rehydration time; the empty codec counts would misclassify
            return ts.shape_class
        if faults.PLAN is not None:
            faults.PLAN.fire("classify", tenant=ts.tid,
                             registry=self.registry)
        n, p, g = ts.state.counts()
        ts.shape_class = self.ladder.classify(n, g, p, tenant=ts.tid)
        return ts.shape_class

    # ---- serial world assembly (legacy + constrained + no-batching path) ----

    def _tensors_with_constraints(self, ts: _Tenant | None = None):
        """Exported tensors + the constraint overlay (side-channel specs +
        resident planes) — what encode_cluster produces natively. `ts`
        defaults to the default tenant (single-tenant callers)."""
        from kubernetes_autoscaler_tpu_torch.sidecar.constraints import (
            attach_constraints,
        )

        if ts is None:
            ts = self._tenant("")
        if ts.rehydrated:
            # the serial/constrained tier assembles from the NATIVE world,
            # which a warm restart does not restore — the client must
            # re-send before this path can serve (FAILED cold fallback)
            raise WorldValidationError(
                "rehydration-pending",
                "tenant restored from checkpoint serves batched sims only; "
                "the serial/constrained path requires an ApplyDelta "
                "world re-send")
        # serial-path residency: the assembled world is immutable once
        # built, and every ApplyDelta bumps the codec version (aux rides
        # the same payload) — so (version, buckets) keys a safe cache and
        # steady serial/constrained tenants stop re-uploading per RPC
        key = (ts.state.version, self.node_bucket, self.group_bucket)
        if ts.serial_cache is not None and ts.serial_cache[0] == key:
            return ts.serial_cache[1]
        nt, gt, pt = ts.state.to_tensors(self.node_bucket, self.group_bucket,
                                         device=self.device)
        planes, has_c = None, False
        if ts.aux:
            gt, planes, has_c = attach_constraints(
                ts.state, gt, nt.n, ts.aux,
                max_zones=self.dims.max_zones)
        out = (nt, gt, pt, planes, has_c)
        if self.hbm_budget_frac > 0 and device.LEDGER is not None:
            # the serial/constrained tier passes the SAME admission gate as
            # the batched path. The check is post-assembly (the tier has no
            # class-shaped projection to price beforehand), so it refuses
            # RESIDENCY — the over-budget world is neither cached nor
            # tagged, and the transient arrays die with this call
            limit = self._hbm_limit()
            if limit > 0:
                self._hbm_budget_screen(
                    ts.tid, device.device_bytes((nt, gt, pt)), limit)
        ts.serial_cache = (key, out)
        if device.LEDGER is not None:
            # serial/constrained tenants hold their assembled world
            # resident too (the version-keyed cache above) — same owner
            # tag as the batched lanes, so the census sees every tier
            device.LEDGER.track("tenant_export",
                                f"{ts.tid or 'default'}/serial",
                                (nt, gt, pt), tenant=ts.tid)
        return out

    def _encode_groups(self, ts: _Tenant, params: SimParams, bucket: int = 8):
        """Lower a request's node-group templates against the tenant's zone
        interning. Returns (NodeGroupTensors, ids)."""
        from kubernetes_autoscaler_tpu_torch.models.api import Node, Taint
        from kubernetes_autoscaler_tpu_torch.models.encode import encode_node_groups
        from kubernetes_autoscaler_tpu_torch.models.resources import (
            ExtendedResourceRegistry,
        )

        templates = []
        ids = []
        for g in params.node_groups or []:
            t = g["template"]
            node = Node(
                name=t.get("name", g["id"]),
                labels=t.get("labels", {}),
                capacity=t.get("capacity", {}),
                allocatable=t.get("allocatable", t.get("capacity", {})),
                taints=[Taint(**x) for x in t.get("taints", [])],
            )
            templates.append((node, g.get("max_new", 1000), g.get("price", 1.0)))
            ids.append(g["id"])
        groups = encode_node_groups(
            templates, ExtendedResourceRegistry(),
            # align template zone ids with the codec's interning so the
            # constrained tier compares zones in ONE id space
            ts.state.zone_table_for_templates(
                [t.zone() for t, _, _ in templates]),
            self.dims, bucket=bucket, device=self.device,
        )
        return groups, ids

    # ---- rpc: ScaleUpSim ----

    def _admit_sim(self, tenant: str, params: SimParams, kind: str) -> None:
        """The admission edge every sim passes BEFORE a ticket exists:
        dead-scheduler fail-fast (UNAVAILABLE — nothing would drain the
        queue), quarantine sentence check (FAILED_PRECONDITION), and the
        request-side structural validation (INVALID_ARGUMENT)."""
        if self._not_serving:
            raise SchedulerDown(self._not_serving)
        self._check_quarantine(tenant)
        try:
            self._validate_params(params, kind)
        except WorldValidationError as e:
            self._note_validation_reject(tenant, e)
            raise

    def scale_up_sim(self, params: SimParams, tenant: str = "") -> dict:
        entry_ns = _time.perf_counter_ns()
        self._admit_sim(tenant, params, "up")
        ts = self._tenant(tenant)
        if self._batchable(ts):
            return self._submit("up", ts, params, entry_ns)
        try:
            return self._scale_up_serial(ts, params, entry_ns)
        except WorldValidationError as e:
            self._note_validation_reject(tenant, e)
            raise

    def _scale_up_serial(self, ts: _Tenant, params: SimParams,
                         entry_ns: int = 0) -> dict:
        from kubernetes_autoscaler_tpu_torch.ops.autoscale_step import scale_up_sim

        stamps = Stamps(entry=entry_ns or _time.perf_counter_ns())
        with ts.lock:
            self._classify(ts)
            nt, gt, pt, planes, has_c = self._tensors_with_constraints(ts)
            groups, ids = self._encode_groups(ts, params)
        stamps.enqueue = _time.perf_counter_ns()   # encode done
        with self._recompile_charge([ts]):
            out = self._timed_sim(
                lambda: scale_up_sim(nt, gt, pt, groups, self.dims,
                                     params.max_new_nodes, params.strategy,
                                     planes=planes, with_constraints=has_c),
                census=("scale_up_sim", scale_up_sim,
                        (nt, gt, pt, groups, self.dims,
                         params.max_new_nodes, params.strategy),
                        {"planes": planes, "with_constraints": has_c}),
                tenant=ts.tid if not ts.dispatched else "")
        stamps.dispatched = _time.perf_counter_ns()
        out = _fetch_serial(out)
        best = int(out.best)
        resp = {
            "best": ids[best] if 0 <= best < len(ids) else "",
            "options": [
                {
                    "id": ids[i],
                    "node_count": int(out.estimate.node_count[i]),
                    "pods": int(out.scores.pods[i]),
                    "waste": float(out.scores.waste[i]),
                    "price": float(out.scores.price[i]),
                    "valid": bool(out.scores.valid[i]),
                }
                for i in range(len(ids))
            ],
            "fits_existing": int(np.asarray(out.fits_existing).sum()),
            "remaining": int(np.asarray(out.remaining).sum()),
        }
        stamps.harvested = _time.perf_counter_ns()
        return self._finish_lifecycle(ts, stamps, resp)

    # ---- rpc: ScaleDownSim ----

    def scale_down_sim(self, params: SimParams, tenant: str = "") -> dict:
        entry_ns = _time.perf_counter_ns()
        self._admit_sim(tenant, params, "down")
        ts = self._tenant(tenant)
        if self._batchable(ts):
            return self._submit("down", ts, params, entry_ns)
        try:
            return self._scale_down_serial(ts, params, entry_ns)
        except WorldValidationError as e:
            self._note_validation_reject(tenant, e)
            raise

    def _scale_down_serial(self, ts: _Tenant, params: SimParams,
                           entry_ns: int = 0) -> dict:
        from kubernetes_autoscaler_tpu_torch.ops.autoscale_step import scale_down_sim

        stamps = Stamps(entry=entry_ns or _time.perf_counter_ns())
        with ts.lock:
            self._classify(ts)
            nt, gt, pt, planes, has_c = self._tensors_with_constraints(ts)
        stamps.enqueue = _time.perf_counter_ns()   # encode done
        with self._recompile_charge([ts]):
            out = self._timed_sim(
                lambda: scale_down_sim(nt, gt, pt, params.threshold,
                                       planes=planes,
                                       max_zones=self.dims.max_zones,
                                       with_constraints=has_c),
                census=("scale_down_sim", scale_down_sim,
                        (nt, gt, pt, params.threshold),
                        {"planes": planes, "max_zones": self.dims.max_zones,
                         "with_constraints": has_c}),
                tenant=ts.tid if not ts.dispatched else "")
        stamps.dispatched = _time.perf_counter_ns()
        valid, out = _fetch_serial((nt.valid, _verdicts(out)))
        resp = {
            "eligible": np.nonzero(np.asarray(out.eligible) & valid)[0].tolist(),
            "drainable": np.nonzero(
                np.asarray(out.removal.drainable) & valid)[0].tolist(),
            "utilization": [round(float(u), 4)
                            for u in np.asarray(out.utilization)[valid]],
        }
        stamps.harvested = _time.perf_counter_ns()
        return self._finish_lifecycle(ts, stamps, resp)

    # ---- rpc: WhatIf (counterfactual multiverse, docs/WHATIF.md) ----

    def what_if(self, request: bytes, tenant: str = "") -> dict:
        """Batched what-if evaluation over the tenant's resident world:
        B hypothesis lanes (lane 0 = the null hypothesis, bit-identical to
        a plain fused step on the unperturbed world) through ONE vmapped
        fused dispatch, optionally time-compressed over T rollout loops.

        The lane count is quantized up to a shape-class rung (padding with
        null lanes, masked out of the report), so variant-count churn rides
        the SAME compiled program — B lanes cost 0 steady-state recompiles,
        the same admission contract the tenant batcher gives worlds."""
        entry_ns = _time.perf_counter_ns()
        raw = json.loads(request.decode() or "{}")
        params = SimParams(
            max_new_nodes=raw.get("max_new_nodes", 256),
            strategy=raw.get("strategy", "least-waste"),
            threshold=raw.get("threshold", 0.5),
            node_groups=raw.get("node_groups"),
        )
        self._admit_sim(tenant, params, "up")
        ts = self._tenant(tenant)
        try:
            return self._what_if_serial(ts, raw, params, entry_ns)
        except WorldValidationError as e:
            self._note_validation_reject(tenant, e)
            raise

    def _what_if_serial(self, ts: _Tenant, raw: dict, params: SimParams,
                        entry_ns: int = 0) -> dict:
        from kubernetes_autoscaler_tpu_torch.whatif import (
            generator as wgen,
            kernel as wkernel,
            report as wreport,
            variants as wvariants,
        )

        stamps = Stamps(entry=entry_ns or _time.perf_counter_ns())
        vs = [wvariants.VariantSpec.from_dict(d)
              for d in raw.get("variants", [])]
        rollout_t = int(raw.get("rollout", 0))
        with ts.lock:
            self._classify(ts)
            nt, gt, pt, planes, has_c = self._tensors_with_constraints(ts)
            groups, ids = self._encode_groups(ts, params)
        if has_c:
            # the multiverse lanes run the unconstrained fused body — same
            # split the tenant batcher makes (constraint overlays stay on
            # the serial planes-attached tier)
            raise WorldValidationError(
                "whatif-constrained",
                "what-if lanes do not carry constraint overlays; drop the "
                "aux constraints or use the serial sims")
        branch = wvariants.Branch(
            nodes=nt, specs=gt, scheduled=pt, groups=groups,
            limit_cap=np.minimum(
                to_host(groups.max_new, np.int64),
                np.int64(params.max_new_nodes)).astype(np.int32),
            statics={
                "dims": self.dims,
                "max_new_nodes": params.max_new_nodes,
                "max_pods_per_node": 128,
                "with_constraints": False,
            },
            meta={"source": "tenant", "tenant": ts.tid, "groups": ids},
        )
        # lane-count admission: pad B up to a rung so variant churn never
        # changes the dispatch shape (counted on the shape-class counters)
        want = len(vs) + (0 if vs and vs[0].is_null() else 1)
        lanes = wvariants.build_lanes(branch, vs, pad_to=rung(want, 4))
        stamps.enqueue = _time.perf_counter_ns()   # encode done

        st = lanes.statics
        kw = dict(dims=st["dims"], max_new_nodes=st["max_new_nodes"],
                  max_pods_per_node=st["max_pods_per_node"],
                  strategy=params.strategy)
        margs = (lanes.nodes, lanes.specs, lanes.scheduled, lanes.groups,
                 lanes.limit_cap)
        with self._recompile_charge([ts]):
            decision, summary = self._timed_sim(
                lambda: wkernel.multiverse_step(*margs, **kw),
                census=("multiverse_step", wkernel.multiverse_step,
                        margs, kw),
                tenant=ts.tid if not ts.dispatched else "")
            traj = wl = None
            if rollout_t > 0:
                wl = wgen.WorkloadSpec.from_record(
                    raw.get("workload") or {"kind": "quiet"})
                g = int(lanes.specs.count.shape[1])
                n = int(lanes.nodes.valid.shape[1])
                adds, fails = wgen.generate_workload(wl, rollout_t, g, n)
                adds_b, fails_b = wgen.lane_workloads(
                    lanes.variants, adds, fails)
                rargs = margs + (lanes.thresholds, adds_b, fails_b)
                traj = self._timed_sim(
                    lambda: wkernel.rollout_multiverse(*rargs, **kw),
                    census=("rollout_multiverse",
                            wkernel.rollout_multiverse, rargs, kw),
                    tenant="")
        stamps.dispatched = _time.perf_counter_ns()
        resp = wreport.build_report(lanes, summary=summary,
                                    decision=decision, traj=traj,
                                    workload=wl)
        stamps.harvested = _time.perf_counter_ns()
        return self._finish_lifecycle(ts, stamps, resp)

    # ---- batched dispatch path ----

    def _batchable(self, ts: _Tenant) -> bool:
        # tenants with a constraint overlay need the planes-attached serial
        # tier; everyone else rides the vmapped batch (docs/SERVING.md)
        return self._scheduler is not None and not ts.aux

    def _export_np(self, ts: _Tenant):
        """Class-shaped numpy export, cached PLANE-GRANULARLY: each section
        (nodes/groups/pods) is keyed by its own codec section version + its
        class axis rung, so a delta that touched one section re-exports
        exactly that section (ISSUE 11 fix — the old (version, class) key
        re-materialized the whole export on any single-pod delta). Caller
        holds ts.lock. The geometric rungs make `pad_to(n, rung) == rung`,
        so every tenant of a class exports identical tensor shapes."""
        if ts.rehydrated:
            # warm restart: serve the checkpoint-restored planes as-is —
            # the empty codec must not overwrite them; the first ApplyDelta
            # re-send exits this mode (_exit_rehydration)
            return ts.export_np["nodes"], ts.export_np["groups"], \
                ts.export_np["pods"]
        sc = self._classify(ts)
        sv = ts.state.section_versions()
        refreshed = []
        grew = False
        for section, svi, rung_n, exporter in (
                ("nodes", sv[0], sc.nodes, ts.state.export_nodes),
                ("groups", sv[1], sc.groups, ts.state.export_groups),
                ("pods", sv[2], sc.pods, ts.state.export_pods)):
            key = (svi, rung_n)
            prev = ts.export_keys.get(section)
            if prev != key:
                ts.export_np[section] = exporter(rung_n)
                ts.export_keys[section] = key
                refreshed.append(section)
                grew = grew or (prev is not None and prev[1] != rung_n)
        if refreshed:
            self._note_encode(ts, refreshed, grew)
        return ts.export_np["nodes"], ts.export_np["groups"], \
            ts.export_np["pods"]

    def _note_encode(self, ts: _Tenant, refreshed: list[str],
                     grew: bool) -> None:
        """The reasoned encode counter, sidecar edition: mode=delta when
        the plane-granular cache reused ≥1 resident section, mode=full when
        every section re-materialized (cause=initial on the first export,
        shape_overflow when an axis crossed its rung — a new padded shape —
        churn otherwise). Tenant-labelled; stale-zeroed by drop_tenant."""
        from kubernetes_autoscaler_tpu_torch.models.world_store import ENCODES_HELP

        first = len(ts.encode_modes) == 0
        mode = "full" if len(refreshed) == 3 else "delta"
        cause = ("initial" if first
                 else "shape_overflow" if grew else "churn")
        key = f"{mode}/{cause}"
        ts.encode_modes[key] = ts.encode_modes.get(key, 0) + 1
        labels = {"tenant": ts.tid} if ts.tid else {}
        self.registry.counter("encoder_encodes_total",
                              help=ENCODES_HELP).inc(mode=mode, cause=cause,
                                                     **labels)

    def _export_dev(self, ts: _Tenant):
        """The tenant's RESIDENT device lanes: per-section device arrays
        refreshed only when that section's numpy export refreshed. The
        upload is the ONLY h2d movement on the batched path — stacking
        happens on-device (batch.stack_fields uses jnp.stack for device
        lanes) — so a steady window moves zero world bytes, and a one-pod
        delta uploads one tenant's dirty sections, not the whole stack.
        Caller holds ts.lock. Each upload is a blocking copy from the
        section's freshly exported arrays, so it has landed before the
        ticket that carries the lane is queued."""
        import torch

        from kubernetes_autoscaler_tpu_torch.models.world_store import H2D_HELP

        self._export_np(ts)
        if faults.PLAN is not None:
            faults.PLAN.fire("h2d", tenant=ts.tid, registry=self.registry)
        uploaded = 0
        for section in ("nodes", "groups", "pods"):
            key = ts.export_keys[section]
            if ts.dev_keys.get(section) != key:
                np_dict = ts.export_np[section]
                ts.dev_np[section] = {k: torch.as_tensor(v, device=self.device)
                                      for k, v in np_dict.items()}
                ts.dev_keys[section] = key
                uploaded += sum(int(v.nbytes) for v in np_dict.values())
                if device.LEDGER is not None:
                    # HBM residency ledger: the tenant's resident lanes,
                    # per section (a refreshed section re-registers; the
                    # old arrays expire from the census by weakref)
                    device.LEDGER.track(
                        "tenant_export",
                        f"{ts.tid or 'default'}/{section}",
                        ts.dev_np[section], tenant=ts.tid)
        if uploaded:
            labels = {"tenant": ts.tid} if ts.tid else {}
            self.registry.counter("world_store_h2d_bytes_total",
                                  help=H2D_HELP).inc(uploaded, **labels)
            self.registry.counter(
                "device_transfer_bytes_total",
                help="Host↔device bytes moved by the serving path, by "
                     "direction (h2d = resident-lane section uploads; "
                     "d2h = batched result fetches)",
            ).inc(uploaded, direction="h2d")
        return ts.dev_np["nodes"], ts.dev_np["groups"], ts.dev_np["pods"]

    def _ng_np(self, ts: _Tenant, params: SimParams):
        """Per-tenant cache of lowered request templates (ids + numpy AND
        device NodeGroupTensors fields at the NG rung): steady-state
        tenants re-send the same node-group ladder every loop, and the
        device field map lets the batched path stack template lanes
        on-device with zero re-upload (encode_node_groups already uploaded
        them once — the map just re-exposes those arrays per field)."""
        from kubernetes_autoscaler_tpu_torch.sidecar.batch import nodegroup_np

        ng_rung = rung(max(len(params.node_groups or []), 1), _NG_RUNG_BASE)
        digest = hashlib.sha1(json.dumps(
            params.node_groups or [], sort_keys=True).encode()).hexdigest()
        key = (digest, ng_rung, ts.state.num_zones())
        hit = ts.ng_cache.get(key)
        if hit is not None:
            ts.ng_cache.move_to_end(key)
            return hit
        groups, ids = self._encode_groups(ts, params, bucket=ng_rung)
        ng_dev = {
            "cap": groups.cap, "label_hash": groups.label_hash,
            "taint_exact": groups.taint_exact, "taint_key": groups.taint_key,
            "zone_id": groups.zone_id, "max_new": groups.max_new,
            "price_per_node": groups.price_per_node, "valid": groups.valid,
        }
        val = (nodegroup_np(groups), ids, ng_rung, digest, ng_dev)
        ts.ng_cache[key] = val
        while len(ts.ng_cache) > 8:
            ts.ng_cache.popitem(last=False)
        return val

    def _submit(self, kind: str, ts: _Tenant, params: SimParams,
                entry_ns: int = 0) -> dict:
        from kubernetes_autoscaler_tpu_torch.sidecar import batch as b

        stamps = Stamps(entry=entry_ns or _time.perf_counter_ns())
        with ts.lock:
            # pre-admission world validation: a structurally bad world
            # (negative requests, oversize counts) never reaches a
            # coalescing window where it could take co-tenants down
            self._export_np(ts)
            try:
                self._validate_world(ts)
                # projected-residency screen rides the same taxonomy: a
                # world too big for the HBM budget must never reach a
                # window where its upload OOMs innocent co-tenants
                self._check_hbm_budget(ts)
            except WorldValidationError as e:
                self._note_validation_reject(ts.tid, e)
                raise
            # the RESIDENT device lanes: dirty sections upload here (the
            # only world h2d on the batched path); untouched sections and
            # steady tenants reuse their device arrays as-is
            nodes, groups, pods = self._export_dev(ts)
            sc = ts.shape_class
            if kind == "up":
                _ng, ids, ng_rung, ng_digest, ng_dev = self._ng_np(ts, params)
                lane = b.UpLane(nodes=nodes, groups=groups, pods=pods,
                                ng=ng_dev, ids=ids)
                fp = (ts.tid, ts.state.version, ng_rung, ng_digest)
                key = ("up", sc, ng_rung, params.max_new_nodes,
                       params.strategy)
            else:
                lane = b.DownLane(nodes=nodes, groups=groups, pods=pods,
                                  threshold=float(params.threshold),
                                  valid_np=ts.export_np["nodes"]["valid"])
                fp = (ts.tid, ts.state.version)
                key = ("down", sc, self.dims.max_zones)
        tracer = trace.current_tracer()
        ticket = Ticket(tenant=ts.tid, kind=kind, key=key, lane=lane, fp=fp,
                        trace_id=tracer.trace_id if tracer else None,
                        stamps=stamps)
        try:
            self._queue.submit(ticket)      # raises QueueFull on overload
        except QueueFull as e:
            self._note_reject(ts.tid, e)
            raise
        resp = ticket.wait(self.ticket_timeout_s)
        stamps.woke = _time.perf_counter_ns()
        bi = ticket.batch_info
        if tracer is not None and bi is not None:
            # the coalescing window on the member's own timeline: one
            # `batch` span carrying class/occupancy/member ids, and the RPC
            # span annotated with the batch id so the Perfetto dump links
            # member ↔ batch both ways
            tracer.add_span(
                "batch", cat="sidecar", begin_abs_ns=bi["t0_ns"],
                dur_ns=bi.get("dur_ns", 0), batch_id=bi["batch_id"],
                shape_class=bi["shape_class"], occupancy=bi["occupancy"],
                lanes=bi["lanes"], members=bi["members"])
            tracer.annotate(batch=bi["batch_id"])
        return self._finish_lifecycle(
            ts, stamps, resp, batch_id=bi["batch_id"] if bi else None)

    def _phase_hist(self):
        """The one accessor for `request_phase_seconds` — every touch
        (observe OR a drop_tenant sweep) passes the sub-10µs bucket ladder,
        so whichever call creates the family creates it right (Registry
        only honors buckets on first touch)."""
        return self.registry.histogram(
            "request_phase_seconds",
            help="Per-request serving-lifecycle phase wall clock "
                 "(encode/queue/form/stack/dispatch/harvest/assembly/"
                 "reply — contiguous, sums to e2e)",
            buckets=REQUEST_PHASE_BUCKETS)

    def _finish_lifecycle(self, ts: _Tenant, stamps: Stamps, resp: dict,
                          batch_id: str | None = None) -> dict:
        """One completed request's lifecycle → three surfaces at once:
        per-tenant `request_phase_seconds{phase,tenant}` histograms, a
        closed `lifecycle` span tree on the request's trace, and the
        `lifecycle` block in the response JSON (so the CLIENT can show
        server-side queue time distinct from network time). The phases are
        contiguous intervals — they sum to e2e by construction, which CI
        asserts within tolerance on the bench smoke."""
        labels = {"tenant": ts.tid} if ts.tid else {}
        for name, dur_ns in stamps.phases_ns().items():
            self._phase_hist().observe(dur_ns / 1e9, phase=name, **labels)
        ts.lat_ms.append(stamps.e2e_ns() / 1e6)
        # verdict provenance: digest the response BEFORE the lifecycle block
        # rides in (timings are observation, not decision)
        from kubernetes_autoscaler_tpu_torch.replay.journal import digest_of

        if ts.journal is not None:
            ts.journal.record("verdict", ts.state.version,
                              digest=digest_of(resp))
        tracer = trace.current_tracer()
        if isinstance(resp, dict):
            resp["lifecycle"] = lifecycle_block(
                stamps, batch_id=batch_id,
                trace_id=tracer.trace_id if tracer else None)
        add_lifecycle_spans(tracer, stamps, tenant=ts.tid or "default",
                            **({"batch_id": batch_id} if batch_id else {}))
        return resp

    def _timed_sim(self, fn, census=None, tenant: str = ""):
        """Run one sim dispatch with compile accounting: when the call grew
        a jit cache, its wall clock is (almost entirely) XLA compilation —
        counted as `sim_compiles_total` / `sim_compile_seconds_total` so
        compile stalls on the serving path are a first-class series, not a
        mystery latency spike.

        `census` = (label, jit_fn, args, kwargs): on a compile, the
        compile CENSUS records the variant — which entry point, which shape
        signature, charged to which (fresh) tenant, at what flop/temp-HBM
        cost — so the bare counters resolve to named executables
        (metrics/device.CompileCensus; Statusz + /metrics).

        An ARMED device profiler (breach-triggered or Profilez-armed) wraps
        exactly this dispatch in a bounded jax.profiler.trace session;
        disarmed costs two loads (the PR 12 guard contract)."""
        prof = device.PROFILER
        run = (lambda: prof.capture(fn)[0]) \
            if prof is not None and prof.armed else fn
        c0 = self._sim_cache_size()
        t0 = _time.perf_counter()
        out = run()
        grew = self._sim_cache_size() - c0
        if grew > 0:
            self.registry.counter(
                "sim_compiles_total",
                help="Kernel libraries built by serving dispatches").inc(grew)
            self.registry.counter(
                "sim_compile_seconds_total",
                help="Wall clock of serving dispatches that compiled "
                     "(≈ compile time)").inc(_time.perf_counter() - t0)
            if census is not None:
                label, _jfn, cargs, ckw = census
                self.census.record(label, cargs, ckw, tenant=tenant)
        return out

    def _note_reject(self, tenant: str, e: QueueFull) -> None:
        """Admission-reject accounting, split by WHY (ISSUE 8 fix: a
        RESOURCE_EXHAUSTED previously carried retry-after but no metric
        distinguishing queue overload from a full tenant table)."""
        self.registry.counter(
            "admission_rejects_total",
            help="Requests rejected RESOURCE_EXHAUSTED, by reason "
                 "(queue-full = transient overload; tenant-cap = resident "
                 "world table full, retry alone never helps)",
        ).inc(reason=e.reason)
        with self._events_lock:
            self.events.emit("AdmissionReject", tenant or "default",
                             e.reason, message=str(e), now=_time.time())

    def _sim_cache_size(self) -> int:
        # the port compiles nothing per shape: its only build is a kernel
        # library, loaded once per process
        from kubernetes_autoscaler_tpu_torch.ops.kernels import build

        return build.cache_size()

    def _account_new_tenant(self, tenants: list[_Tenant],
                            recompiles: int) -> None:
        """`recompiles_per_new_tenant`: XLA programs compiled by the first
        dispatch that served each newly admitted tenant. A tenant landing in
        a warm shape class costs 0 — the observable form of the ≈0-recompile
        guarantee (CI-asserted, like PR 2's steady_state_recompiles)."""
        fresh = [t for t in tenants if not t.dispatched]
        for t in tenants:
            t.dispatched = True
        if fresh:
            self.registry.gauge(
                "recompiles_per_new_tenant",
                help="Kernel builds triggered by the dispatch that first "
                     "served a newly admitted tenant (0 = it joined a warm "
                     "shape class)",
            ).set(recompiles / len(fresh))

    @contextlib.contextmanager
    def _recompile_charge(self, tenants: list[_Tenant]):
        """Wrap a dispatch that first serves a fresh tenant in the
        (cache-size, dispatch, cache-size) charge window, under
        _account_lock — the jit caches are process global, so a concurrent
        dispatch on another thread would otherwise have its compiles
        attributed to whichever tenant measured last. Steady dispatches
        (every member already served) skip the lock AND the cache walks:
        nothing to charge, no serialization on the hot path."""
        if all(t.dispatched for t in tenants):
            yield
            return
        with self._account_lock:
            before = self._sim_cache_size()
            yield
            self._account_new_tenant(
                tenants, self._sim_cache_size() - before)

    def _dispatch_batch(self, tickets: list[Ticket],
                        bisect_budget: list | None = None,
                        bisect_tried: set | None = None):
        """Scheduler-thread entry: stack one batch-compatible ticket run,
        dispatch the vmapped program, issue the async result fetch. Returns
        the in-flight handle the scheduler harvests one window later.

        `bisect_budget`/`bisect_tried` are set on bisection re-dispatches:
        the in-flight handle's failure path then recurses into `_bisect`
        with the SAME bounded budget (and singleton-retry history) instead
        of starting a fresh tree."""
        import torch

        from kubernetes_autoscaler_tpu_torch.ops import autoscale_step as a
        from kubernetes_autoscaler_tpu_torch.sidecar import batch as b
        from kubernetes_autoscaler_tpu_torch.ops.hostfetch import fetch_pytree_async

        kind = tickets[0].kind
        key = tickets[0].key
        tenants = [t.tenant for t in tickets]
        t0 = _time.perf_counter_ns()
        for t in tickets:
            t.stamps.stack0 = t0
        members = [t.lane for t in tickets]
        if faults.PLAN is not None:
            faults.PLAN.fire("stack", tenants=tenants,
                             registry=self.registry)
        lanes_list = b.pad_lanes(members, self.batch_lanes)
        stack_key = (key, tuple(t.fp for t in tickets))

        # NOTE on h2d accounting: the lanes are the tenants' RESIDENT
        # device arrays (_export_dev), so a stack-cache miss re-stacks
        # on-device and moves no world bytes — uploads were already
        # charged, per dirty section, when the lanes refreshed.
        tenant_objs = [self._tenant(t.tenant) for t in tickets]
        # census attribution: a compile in this window is charged to the
        # fresh tenant it first serves (the recompiles_per_new_tenant
        # contract, now carrying a NAME); steady windows charge nobody
        fresh_tenant = next(
            (o.tid for o in tenant_objs if not o.dispatched), "")
        with self._recompile_charge(tenant_objs):
            if faults.PLAN is not None:
                faults.PLAN.fire("dispatch", tenants=tenants,
                                 registry=self.registry)
            if kind == "up":
                nt, gt, pt, gr = self._stack_cache.get(
                    stack_key, lambda: b.stack_up_lanes(lanes_list))
                stack1 = _time.perf_counter_ns()
                _, _, _, max_new_nodes, strategy = key
                out = self._timed_sim(
                    lambda: a.scale_up_sim_batch(nt, gt, pt, gr, self.dims,
                                                 max_new_nodes, strategy,
                                                 members=len(tickets)),
                    census=("scale_up_sim_batch", a.scale_up_sim_batch,
                            (nt, gt, pt, gr, self.dims, max_new_nodes,
                             strategy), {}),
                    tenant=fresh_tenant)
                fetch_tree = {
                    "best": out.best,
                    "node_count": out.estimate.node_count,
                    "pods": out.scores.pods,
                    "waste": out.scores.waste,
                    "price": out.scores.price,
                    "valid": out.scores.valid,
                    "fits": out.fits_existing.sum(-1, dtype=torch.int32),
                    "remaining": out.remaining.sum(-1, dtype=torch.int32),
                }
                assemble = lambda host: b.assemble_members(  # noqa: E731
                    host, members, tenants, b.assemble_up_one)
            else:
                nt, gt, pt = self._stack_cache.get(
                    stack_key, lambda: b.stack_down_lanes(lanes_list)[:3])
                stack1 = _time.perf_counter_ns()
                th = torch.tensor([ln.threshold for ln in lanes_list],
                                  dtype=torch.float32, device=self.device)
                out = self._timed_sim(
                    lambda: a.scale_down_sim_batch(
                        nt, gt, pt, th, max_zones=self.dims.max_zones,
                        members=len(tickets)),
                    census=("scale_down_sim_batch", a.scale_down_sim_batch,
                            (nt, gt, pt, th),
                            {"max_zones": self.dims.max_zones}),
                    tenant=fresh_tenant)
                fetch_tree = {
                    "eligible": out.eligible,
                    "drainable": out.removal.drainable,
                    "util": out.utilization,
                }
                assemble = lambda host: b.assemble_members(  # noqa: E731
                    host, members, tenants, b.assemble_down_one)
        occupancy = len(tickets)
        self.occupancies.append(occupancy)
        self.registry.counter(
            "batched_dispatches_total",
            help="Coalesced batched sim dispatches, by kind").inc(kind=kind)
        self.registry.histogram(
            "batch_occupancy",
            help="Member tenants per coalesced dispatch (lanes minus "
                 "padding)",
            buckets=tuple(float(x) for x in range(1, 33)),
        ).observe(float(occupancy), kind=kind)
        # occupancy over time as a scrapeable gauge (device-utilization
        # accounting): what fraction of the compiled lane width carried
        # real member tenants on the latest dispatch
        self.registry.gauge(
            "batch_occupancy_ratio",
            help="Members / compiled lanes of the latest coalesced "
                 "dispatch (1.0 = no padding waste)",
        ).set(occupancy / self.batch_lanes, kind=kind)
        d2h0 = self.phases.events.get("batched_fetch_bytes_moved", 0)
        fetch = fetch_pytree_async(fetch_tree, phases=self.phases)
        self.registry.counter("device_transfer_bytes_total").inc(
            self.phases.events.get("batched_fetch_bytes_moved", 0) - d2h0,
            direction="d2h")
        dispatched_ns = _time.perf_counter_ns()
        for t in tickets:
            t.stamps.stack1 = stack1
            t.stamps.dispatched = dispatched_ns
        batch_info = {
            "batch_id": uuid.uuid4().hex[:8],
            "kind": kind,
            "shape_class": tickets[0].key[1].key,
            "occupancy": occupancy,
            "lanes": self.batch_lanes,
            "members": [{"tenant": t.tenant, "trace_id": t.trace_id}
                        for t in tickets],
            "t0_ns": t0,
        }
        # failure wiring (docs/ROBUSTNESS.md): a batch-level harvest
        # failure enters (or continues) the bounded bisection tree; a
        # per-member poison result quarantines exactly that tenant
        on_failure = ((lambda tks, e: self._bisect(
            tks, e, bisect_budget, bisect_tried))
            if bisect_budget is not None else self._batch_failure)
        # shadow audit rides on_done (post-harvest, every member already
        # resolved — audit latency never sits on a client's critical
        # path); bisection re-dispatches are excluded: their windows exist
        # to LOCALIZE a failure, not to re-verify healthy lanes
        on_done = (self._shadow_audit_window
                   if self.shadow_audit and bisect_budget is None else None)
        return b.InFlightBatch(
            tickets, fetch, assemble, batch_info,
            on_done=on_done,
            on_failure=on_failure,
            on_member_fault=lambda t, e: self._quarantine_tenant(
                t.tenant, self._fault_reason(e), error=e))

    # ---- online shadow audit (one round-robin lane per window) ----------

    def _audit_reference(self, t: "Ticket") -> dict:
        """The independent reference verdict for one member: the SERIAL
        (unbatched) sim program over the member's own lane tensors,
        assembled into the same JSON shape the batched path produced.
        Different compiled executable, same inputs — bit-identical by the
        serial≡batched contract (tests/test_batched_sim.py), so any
        difference is backend corruption, not modeling."""
        import torch

        from kubernetes_autoscaler_tpu_torch.ops import autoscale_step as a
        from kubernetes_autoscaler_tpu_torch.sidecar import batch as b

        ln = t.lane
        nt = b.node_tensors(ln.nodes)
        gt = b.podgroup_tensors(ln.groups)
        pt = b.sched_tensors(ln.pods)
        if t.kind == "up":
            gr = b.nodegroup_tensors(ln.ng)
            _, _, _, max_new, strategy = t.key
            out = a.scale_up_sim(nt, gt, pt, gr, self.dims, max_new,
                                 strategy)
            host = _fetch_serial({
                "best": out.best[None],
                "node_count": out.estimate.node_count[None],
                "pods": out.scores.pods[None],
                "waste": out.scores.waste[None],
                "price": out.scores.price[None],
                "valid": out.scores.valid[None],
                "fits": out.fits_existing.sum(-1, dtype=torch.int32)[None],
                "remaining": out.remaining.sum(-1, dtype=torch.int32)[None],
            })
            return b.assemble_up_one(host, ln, 0)
        out = a.scale_down_sim(nt, gt, pt, ln.threshold,
                               max_zones=self.dims.max_zones)
        host = _fetch_serial({
            "eligible": out.eligible[None],
            "drainable": out.removal.drainable[None],
            "util": out.utilization[None],
        })
        return b.assemble_down_one(host, ln, 0)

    def _shadow_audit_window(self, batch) -> None:
        """InFlightBatch.on_done hook (scheduler thread): pick ONE resolved
        member of this window (round-robin over members, so every tenant's
        lane is audited over time), snapshot its verdict, and hand it to
        the audit worker — the scheduler thread pays a dict copy, never a
        reference re-sim. Best-effort by contract."""
        from kubernetes_autoscaler_tpu_torch.audit.shadow import AUDIT_CHECKS_HELP

        try:
            tickets = [t for t in batch.tickets
                       if isinstance(t.result, dict)]
            if not tickets or self._audit_q is None:
                return
            t = tickets[self._audit_rr % len(tickets)]
            self._audit_rr += 1
            # verdict snapshot, taken NOW: the handler thread this ticket
            # woke is concurrently annotating the same dict in place with
            # per-request metadata (`lifecycle` stamps) the reference path
            # never computes — retry the copy across that single-key
            # insert instead of letting RuntimeError eat the audit
            got = None
            for _attempt in range(3):
                try:
                    got = {k: v for k, v in (t.result or {}).items()
                           if k != "lifecycle"}
                    break
                except RuntimeError:
                    continue
            counter = self.registry.counter("shadow_audit_checks_total",
                                            help=AUDIT_CHECKS_HELP)
            if got is None:
                counter.inc(surface=f"sidecar-{t.kind}",
                            outcome="skipped", tenant=t.tenant)
                return
            try:
                self._audit_q.put_nowait(
                    (t, got, dict(batch.batch_info)))
            except _queue.Full:
                # the worker is behind (a reference compile in flight):
                # drop THIS window's audit, accounted — never block the
                # scheduler loop on verification
                counter.inc(surface=f"sidecar-{t.kind}",
                            outcome="skipped", tenant=t.tenant)
        except Exception:  # noqa: BLE001 — best-effort evidence path
            pass

    def _audit_loop(self) -> None:
        while not self._audit_stop.is_set():
            try:
                item = self._audit_q.get(timeout=0.2)
            except _queue.Empty:
                continue
            t0 = _time.perf_counter_ns()
            try:
                self._audit_one(*item)
            except Exception:  # noqa: BLE001 — the worker must survive
                pass
            finally:
                self.audit_overhead_ns += _time.perf_counter_ns() - t0
                self._audit_q.task_done()

    def audit_quiesce(self, timeout_s: float = 30.0) -> bool:
        """Wait for every enqueued audit to finish (tests/bench — audits
        run async on the worker; asserting counters right after a window
        resolves would race it). True when the queue drained."""
        if self._audit_q is None:
            return True
        deadline = _time.monotonic() + timeout_s
        while _time.monotonic() < deadline:
            if self._audit_q.unfinished_tasks == 0:
                return True
            _time.sleep(0.02)
        return False

    def _audit_one(self, t: "Ticket", got: dict, batch_info: dict) -> None:
        """Worker-thread body: the serial reference re-sim + compare for
        one snapshotted member verdict."""
        from kubernetes_autoscaler_tpu_torch.audit.shadow import AUDIT_CHECKS_HELP

        surface = f"sidecar-{t.kind}"
        # compile-attribution hygiene: only the FIRST audit at a given
        # batch-compat key can compile the serial reference variant — that
        # one runs under _account_lock so the new-tenant charge window
        # never sees audit-grown jit cache; every later audit at the key
        # is a cache hit by construction and runs lock-free (the audit
        # worker must never stall the scheduler's fresh-tenant windows in
        # steady state)
        if t.key in self._audit_warmed:
            ref = self._audit_reference(t)
        else:
            with self._account_lock:
                ref = self._audit_reference(t)
            self._audit_warmed.add(t.key)
        if ref == got:
            self.registry.counter(
                "shadow_audit_checks_total",
                help=AUDIT_CHECKS_HELP).inc(
                surface=surface, outcome="ok", tenant=t.tenant)
            return
        self.audit_divergences += 1
        diff = sorted(k for k in set(ref) | set(got)
                      if ref.get(k) != got.get(k))
        self.audit_last = {
            "tenant": t.tenant or "default", "kind": t.kind,
            "batch": batch_info.get("batch_id", ""),
            "fields": diff, "trace": t.trace_id or "",
        }
        self.registry.counter(
            "shadow_audit_checks_total", help=AUDIT_CHECKS_HELP).inc(
            surface=surface, outcome="divergent", tenant=t.tenant)
        with self._events_lock:
            self.events.emit(
                "AuditDivergence", obj=t.tenant or "default",
                reason=surface,
                message=(f"batched verdict diverged from the serial "
                         f"reference (fields: {', '.join(diff)}; "
                         f"batch {self.audit_last['batch']}) — "
                         f"backend fault, tenant NOT quarantined"))
        # evidence: a retained trace (reason=audit) + the tenant's
        # provenance ring persisted next to the SLO dumps
        tr = trace.Tracer(trace_id=t.trace_id or None)
        tr.add_span("shadow_audit_divergence", cat="audit",
                    tenant=t.tenant or "default", kind=t.kind,
                    batch=self.audit_last["batch"],
                    fields=diff)
        snap = tr.snapshot()
        snap["tenant"] = t.tenant
        self.tail.offer(snap, 0.0, reason="audit")
        if self.slo_dump_dir:
            ts = self._tenant_peek(t.tenant)
            if ts is not None and ts.journal is not None:
                try:
                    os.makedirs(self.slo_dump_dir, exist_ok=True)
                    ts.journal.maybe_persist(self.slo_dump_dir,
                                             reason="audit_divergence")
                except OSError:
                    pass

    def audit_stats(self) -> dict:
        checks: dict[str, float] = {}
        for key, v in self.registry.counter(
                "shadow_audit_checks_total").items():
            d = dict(key)
            k = f"{d.get('surface', '?')}/{d.get('outcome', '?')}"
            checks[k] = checks.get(k, 0.0) + v
        return {
            "enabled": self.shadow_audit,
            "checks": checks,
            "divergences": self.audit_divergences,
            "last": self.audit_last,
            "overhead_ms": round(self.audit_overhead_ns / 1e6, 3),
        }

    def hbm_stats(self) -> dict:
        """The residency-ledger reconciliation, published into this
        service's registry: tagged census per (owner, tenant), the device's
        own totals (hbm_bytes_in_use/limit/headroom) — or the host-RSS
        fallback with `source: host-fallback` on backends without
        memory_stats. Never null (the bench --device-stats contract)."""
        if device.LEDGER is None:
            return {"source": "disabled"}
        return device.LEDGER.reconcile(registry=self.registry,
                                       hbm_limit_bytes=self.hbm_limit_bytes)

    def profilez(self, payload: bytes = b"") -> dict:
        """The armed-handle device-profiler RPC (the /snapshotz pattern):
        body `{"arm": true, "reason": "..."}` arms the profiler — the NEXT
        sim dispatch is captured into a trace-id-stamped directory; an
        empty body just reports state. Rate limits apply to manual arms
        exactly like breach arms."""
        req = {}
        if payload:
            try:
                req = json.loads(payload.decode() or "{}")
            except ValueError:
                return {"enabled": device.PROFILER is not None,
                        "error": "malformed Profilez body (want JSON)"}
        prof = device.PROFILER
        if prof is None:
            return {"enabled": False,
                    "error": "no device profiler installed "
                             "(--device-profile-dir)"}
        out = {"enabled": True}
        if req.get("arm"):
            tracer = trace.current_tracer()
            out["armed_now"] = prof.arm(
                str(req.get("reason") or "manual"),
                trace_id=tracer.trace_id if tracer else "")
        out.update(prof.stats())
        return out

    def batch_stats(self) -> dict:
        """Bench/ops view of the batching layer."""
        occ = list(self.occupancies)
        return {
            "windows": self._scheduler.windows if self._scheduler else 0,
            "batches": self._scheduler.batches if self._scheduler else 0,
            "occupancy_p50": (float(np.percentile(occ, 50)) if occ else None),
            "stack_cache": (
                {"hits": self._stack_cache.hits,
                 "misses": self._stack_cache.misses}
                if self._scheduler else None),
            "shape_class_hits": self.ladder.hits,
            "shape_class_misses": self.ladder.misses,
            "queue_rejected": self._queue.rejected if self._queue else 0,
            "recompiles_per_new_tenant": self.registry.gauge(
                "recompiles_per_new_tenant").value(),
            "dispatch_gap": self.gap_stats(),
            "tail_sampler": self.tail.stats(),
        }

    def gap_stats(self) -> dict:
        """Dispatch-gap summary: the `pipelined`+`stall` population is the
        device-idle-while-work-existed distribution (≈0 under pipelining);
        `idle` is arrival-bound and summarized separately."""
        gaps = list(self.gaps)
        busy = [g for g, c in gaps if c in ("pipelined", "stall")]
        idle = [g for g, c in gaps if c == "idle"]
        stalls = sum(1 for _, c in gaps if c == "stall")
        return {
            "dispatches": len(gaps),
            "p50_ms": (round(float(np.percentile(busy, 50)) * 1000, 4)
                       if busy else None),
            "p99_ms": (round(float(np.percentile(busy, 99)) * 1000, 4)
                       if busy else None),
            "stalls": stalls,
            "idle_s_total": round(sum(idle), 4),
        }

    def tenant_stats(self, tid: str) -> dict:
        """One tenant's serving view (statusz row)."""
        ts = self._tenant_peek(tid)
        if ts is None:
            return {}
        lat = list(ts.lat_ms)
        pct = (lambda q: round(float(np.percentile(lat, q)), 3)) \
            if lat else (lambda q: None)
        return {
            "tenant": tid or "default",
            "shape_class": ts.shape_class.key if ts.shape_class else "-",
            "version": ts.state.version,
            "requests": len(lat),
            "p50_ms": pct(50), "p95_ms": pct(95), "p99_ms": pct(99),
            "slo_budget_ms": self.slo.get(tid) or None,
            "slo_breaches": ts.slo_breaches,
            "last_breach_trace": ts.last_breach_trace or None,
            "journal": ts.journal.stats() if ts.journal is not None else None,
            # plane-granular export accounting (ISSUE 11): how this
            # tenant's world reached the device, by mode/cause. Copied
            # under ts.lock — _note_encode inserts keys under it on
            # handler threads, and iterating a mutating dict RuntimeErrors
            "encodes": self._encode_modes(ts),
        }

    @staticmethod
    def _encode_modes(ts: _Tenant) -> dict:
        with ts.lock:
            return dict(ts.encode_modes)

    def statusz(self) -> str:
        """Human-readable serving snapshot (the sidecar's /statusz analog,
        served by the Statusz RPC): tenant table with latency percentiles
        and SLO state, queue + reject accounting, shape-class hit rates,
        batching/occupancy/dispatch-gap figures, tail-sampler budget, and
        the last-breach exemplar trace ids — the one-page view an operator
        reads before opening /metrics or a Perfetto dump."""
        lines = [f"katpu-sidecar statusz @ {_time.strftime('%Y-%m-%dT%H:%M:%SZ', _time.gmtime())}"]
        with self._tenants_lock:
            tids = sorted(self._tenants)
        lines.append(f"tenants: {len(tids)} active (cap {self.max_tenants})")
        lines.append("  tenant          class            ver   reqs   "
                     "p50ms    p95ms    p99ms  slo_ms  breaches  last_breach")
        for tid in tids:
            st = self.tenant_stats(tid)
            if not st:
                continue
            lines.append(
                f"  {st['tenant']:<15} {st['shape_class']:<16} "
                f"{st['version']:>4}  {st['requests']:>5}  "
                f"{st['p50_ms'] if st['p50_ms'] is not None else '-':>7}  "
                f"{st['p95_ms'] if st['p95_ms'] is not None else '-':>7}  "
                f"{st['p99_ms'] if st['p99_ms'] is not None else '-':>7}  "
                f"{st['slo_budget_ms'] or '-':>6}  {st['slo_breaches']:>8}  "
                f"{st['last_breach_trace'] or '-'}")
        q = self._queue
        rej = self.registry.counter("admission_rejects_total")
        lines.append(
            f"queue: depth={q.depth if q else 0} "
            f"submitted={q.submitted if q else 0} "
            f"rejected=[queue-full={rej.value(reason='queue-full'):.0f} "
            f"tenant-cap={rej.value(reason='tenant-cap'):.0f}]")
        lines.append(
            f"shape classes: {len(self.ladder.seen())} seen, "
            f"hits={self.ladder.hits} misses={self.ladder.misses} "
            f"hit_rate={self.ladder.hit_rate():.3f}")
        gs = self.gap_stats()
        occ = list(self.occupancies)
        lines.append(
            f"batching: lanes={self.batch_lanes} "
            f"windows={self._scheduler.windows if self._scheduler else 0} "
            f"batches={self._scheduler.batches if self._scheduler else 0} "
            f"occupancy_p50={float(np.percentile(occ, 50)) if occ else '-'} "
            f"dispatch_gap_p50_ms={gs['p50_ms'] if gs['p50_ms'] is not None else '-'} "
            f"stalls={gs['stalls']} idle_s={gs['idle_s_total']}")
        tstats = self.tail.stats()
        lines.append(
            f"tail sampler: offered={tstats['offered']} "
            f"retained={tstats['retained']} evicted={tstats['evicted']} "
            f"held={tstats['held']} reasons={json.dumps(tstats['reasons'], sort_keys=True)}")
        # shadow audit (docs/OBSERVABILITY.md "Shadow audit"): one
        # round-robin lane per window re-verified against the serial
        # reference — divergence is a backend fault, never a quarantine
        au = self.audit_stats()
        if au["enabled"]:
            lines.append(
                f"shadow audit: checks={json.dumps(au['checks'], sort_keys=True)} "
                f"divergences={au['divergences']} "
                f"overhead_ms={au['overhead_ms']}")
            if au["last"]:
                la = au["last"]
                lines.append(
                    f"  last divergence: tenant={la['tenant']} "
                    f"kind={la['kind']} batch={la['batch']} "
                    f"fields={','.join(la['fields'])} "
                    f"trace={la['trace'] or '-'}")
        else:
            lines.append("shadow audit: disabled")
        # fault-domain isolation (docs/ROBUSTNESS.md): quarantine table,
        # window-failure/bisection accounting, rehydration + chaos plane
        qs = self.quarantine_stats()
        wrej = self.registry.counter("world_validation_rejects_total")
        lines.append(
            f"quarantine: {len(qs)} tenants (ttl {self.quarantine_ttl_s}s) "
            f"quarantined_total={self.registry.counter('tenant_quarantined_total').total():.0f} "
            f"paroled_total={self.registry.counter('tenant_paroled_total').total():.0f} "
            f"window_failures={self.registry.counter('window_failures_total').total():.0f} "
            f"redispatches={self.registry.counter('window_redispatches_total').total():.0f} "
            f"validation_rejects={wrej.total():.0f}")
        for t in sorted(qs):
            q = qs[t]
            lines.append(f"  {t:<15} reason={q['reason']} "
                         f"count={q['count']} "
                         f"parole_in={q['remaining_s']}s")
        rh = self.rehydration
        lines.append(
            f"warm restart: restored={rh['restored']} "
            f"digest_mismatch={rh['digest_mismatch']} "
            f"errors={rh['error']} "
            f"scheduler={'NOT_SERVING (' + self._not_serving + ')' if self._not_serving else 'serving'}")
        if faults.PLAN is not None:
            fs = faults.PLAN.stats()
            lines.append(
                f"faults: ACTIVE seed={fs['seed']} "
                f"specs={len(fs['specs'])} fired={fs['fired_total']}")
            for ent in fs["log_tail"]:
                lines.append(f"  #{ent['seq']} {ent['hook']}/{ent['kind']} "
                             f"spec={ent['spec']} tenant={ent['tenant'] or '-'}")
        else:
            lines.append("faults: disabled")
        # flight-journal section: per-tenant provenance ring accounting
        # (records/bytes/held/drops/persists), capped like the tenant table
        jrows = []
        jtot = {"records": 0, "bytes": 0, "dropped": 0, "persisted": 0}
        for tid in tids:
            ts = self._tenant_peek(tid)
            if ts is None or ts.journal is None:
                continue
            js = ts.journal.stats()
            for k in jtot:
                jtot[k] += js[k]
            jrows.append(
                f"  {js['tenant']:<15} records={js['records']:>6} "
                f"bytes={js['bytes']:>8} held={js['held']:>4} "
                f"dropped={js['dropped']} persisted={js['persisted']}")
        lines.append(
            f"journal: tenants={len(jrows)} cap={self.journal_capacity}/tenant "
            f"records={jtot['records']} bytes={jtot['bytes']} "
            f"dropped={jtot['dropped']} persisted={jtot['persisted']}")
        lines.extend(jrows)
        comp = self.registry.counter("sim_compiles_total")
        xfer = self.registry.counter("device_transfer_bytes_total")
        lines.append(
            f"device: compiles={comp.value():.0f} "
            f"compile_s={self.registry.counter('sim_compile_seconds_total').value():.3f} "
            f"h2d_bytes={xfer.value(direction='h2d'):.0f} "
            f"d2h_bytes={xfer.value(direction='d2h'):.0f}")
        # HBM residency ledger: tagged census vs device totals, per owner
        # component and tenant (docs/OBSERVABILITY.md "Device surfaces")
        hs = self.hbm_stats()
        if hs.get("source") == "disabled":
            lines.append("hbm: ledger disabled")
        else:
            head = hs.get("headroom_ratio")
            lines.append(
                f"hbm: source={hs['source']} in_use={hs['bytes_in_use']} "
                f"limit={hs['bytes_limit']} tagged={hs['tagged_bytes']} "
                f"untagged={hs['untagged_bytes']} "
                f"headroom={f'{head:.3f}' if head is not None else '-'} "
                f"budget_frac={self.hbm_budget_frac or '-'} "
                f"budget_rejects={self.registry.counter('world_validation_rejects_total').value(reason='hbm-budget'):.0f}")
            for k, v in hs.get("by_owner_tenant", {}).items():
                lines.append(f"  {k:<28} {v} bytes")
        # compile census: named variants instead of a bare compile count
        variants = self.census.variants()
        lines.append(f"compile census: {len(variants)} variants "
                     f"(mode={self.census.mode})")
        for e in variants[:16]:
            lines.append(
                f"  {e['fn']:<22} sig={e['shape_sig']:<22} "
                f"compiles={e['compiles']} "
                f"tenants={','.join(e['tenants']) or '-'}"
                + (f" flops={e['flops']:.3g}" if "flops" in e else "")
                + (f" temp_b={e['temp_bytes']}" if "temp_bytes" in e else ""))
        prof = device.PROFILER
        if prof is not None:
            ps = prof.stats()
            lines.append(
                f"profiler: dir={ps['dir']} armed={ps['armed']} "
                f"captures={ps['captures']}/{ps['max_captures']} "
                f"throttled={ps['throttled']}"
                + (f" last={ps['last']['path']}" if ps["last"] else ""))
        else:
            lines.append("profiler: disabled")
        # world-store section: encode modes aggregated across resident
        # tenants (delta = plane-granular refresh reused resident sections)
        emodes: dict[str, int] = {}
        for tid in tids:
            ets = self._tenant_peek(tid)
            if ets is not None:
                for k, v in self._encode_modes(ets).items():
                    emodes[k] = emodes.get(k, 0) + v
        wsb_total = self.registry.counter(
            "world_store_h2d_bytes_total").total()
        lines.append(
            "world store: encodes="
            + json.dumps(emodes, sort_keys=True)
            + f" h2d_world_bytes={wsb_total:.0f}")
        # EventSink isn't thread-safe: the reject path emits under
        # _events_lock on handler threads, so the statusz read takes it too
        with self._events_lock:
            events = self.events.snapshot()
        if events:
            lines.append(f"events ({len(events)} stored, newest last):")
            for ev in events[-8:]:
                lines.append(f"  {ev['kind']} {ev['object']}: "
                             f"{ev['reason']} x{ev['count']}")
        hist_dir = os.environ.get("KATPU_PERF_HISTORY")
        if hist_dir:
            # perf trajectory tail: a sidecar pointed at a perfwatch store
            # serves the recent bench series so fleet perf is inspectable
            # without pulling artifacts (docs/BENCH.md "Trajectory &
            # regression gate")
            try:
                from ..perfwatch.history import PerfHistory
                from ..perfwatch.report import trajectory_lines
                if not os.path.isdir(hist_dir):
                    # a status read must not mkdir a mistyped store path
                    raise FileNotFoundError(hist_dir)
                hist = PerfHistory(hist_dir)
                st = hist.stats()
                lines.append(
                    f"perf history: dir={hist_dir} rows={st['rows']} "
                    f"dropped={st['dropped_rows']} "
                    f"lineages={json.dumps(st['lineages'], sort_keys=True)}")
                for ln in trajectory_lines(hist.load(), last=5):
                    lines.append("  " + ln)
            except Exception as exc:  # tampered/unreadable store: surface it
                lines.append(f"perf history: unreadable ({exc})")
        return "\n".join(lines) + "\n"

    def _on_complete(self, method: str, tenant: str, dt_s: float,
                     tracer: "trace.Tracer | None",
                     error: Exception | None = None) -> str | None:
        """Per-request completion hook (traced_call): feed the tail
        sampler, check the tenant's SLO budget, and return the retained
        exemplar trace id (if any) for the latency histogram bucket.

        A breach bumps `tenant_slo_breaches_total{tenant}` and persists a
        TENANT-SCOPED dump: only this tenant's retained request traces
        (TailSampler.tenant_traces), never the whole ring — the serving
        analog of the FlightRecorder's loop-scoped breach dump."""
        ts = self._tenant_peek(tenant)
        breached = self.slo.breached(tenant, dt_s)
        reason = None
        if error is not None:
            reason = ("backpressure" if isinstance(error, QueueFull)
                      else "failed")
        elif breached:
            reason = "slo_breach"
        exemplar = None
        if tracer is not None:
            snap = tracer.snapshot()
            snap["tenant"] = tenant
            snap["method"] = method
            # a retained trace names its replayable provenance: the
            # tenant-journal cursor at completion time
            if ts is not None and ts.journal is not None:
                cur = ts.journal.cursor()
                if cur is not None:
                    snap["journal_seq"], snap["journal_digest"] = cur
            exemplar = self.tail.offer(snap, dt_s, reason)
            if exemplar and device.PROFILER is not None:
                # tail retention arms the device profiler: the NEXT sim
                # dispatch runs under a bounded jax.profiler.trace session
                # whose capture dir is stamped with THIS retained trace id
                # + journal cursor (rate-limited inside arm(); a throttled
                # arm is a counter bump, not a capture)
                cur = (snap.get("journal_seq"), snap.get("journal_digest"))
                device.PROFILER.arm(
                    reason or "slow", trace_id=exemplar,
                    journal_cursor=cur if cur[0] is not None else None)
        else:
            self.tail.observe_latency(dt_s)
        if reason in ("slo_breach", "backpressure") and self.slo_dump_dir \
                and ts is not None and ts.journal is not None:
            # breach/backpressure-triggered retention (the TailSampler
            # pattern): the in-memory provenance ring hits disk only now —
            # deduped by ring watermark, because backpressure fires exactly
            # when the server is saturated and the reject path must stay a
            # cheap fast-reject (maybe_persist writes once per NEW history,
            # an overload storm re-persists nothing)
            try:
                import os

                os.makedirs(self.slo_dump_dir, exist_ok=True)
                ts.journal.maybe_persist(self.slo_dump_dir, reason=reason)
            except OSError:
                pass   # a full disk must never sink the RPC
        if breached:
            self.registry.counter(
                "tenant_slo_breaches_total",
                help="Requests exceeding their tenant's latency budget "
                     "(sidecar/lifecycle.SloBudgets)",
            ).inc(tenant=tenant or "default")
            if ts is not None:
                ts.slo_breaches += 1
                if exemplar:
                    ts.last_breach_trace = exemplar
            if self.slo_dump_dir and tracer is not None:
                try:
                    import os

                    os.makedirs(self.slo_dump_dir, exist_ok=True)
                    self.tail.dump(
                        os.path.join(
                            self.slo_dump_dir,
                            f"slo-{tenant or 'default'}-{tracer.trace_id}"
                            f".trace.json"),
                        self.tail.tenant_traces(tenant))
                except OSError:
                    pass   # a full disk must never sink the RPC
        return exemplar

    def health(self) -> dict:
        """SERVING, or NOT_SERVING once the batch scheduler crashed (the
        supervision contract: a sidecar whose dispatch thread is dead must
        not look healthy to orchestration OR to client half-open probes)."""
        if self._not_serving:
            return {"version": self.state.version, "status": "NOT_SERVING",
                    "error": self._not_serving,
                    "tenants": len(self._tenants)}
        return {"version": self.state.version, "status": "SERVING",
                "error": "", "tenants": len(self._tenants)}

    # ---- rpc: Metricz ----

    def metricz(self) -> str:
        """The sidecar's /metricz analog: its own Registry (per-RPC counters
        and duration histograms, `katpu_sidecar_*`) FOLLOWED BY the
        process-wide default registry (`cluster_autoscaler_*`, including
        `# HELP` lines and the reason-labelled families) in prometheus
        exposition text. Serving both means the main-process `/metrics` mux
        and this RPC expose the same autoscaler families — a scrape of
        either surface sees the reason plane (asserted by
        tests/test_reason_plane.py). Plain text on the wire, not JSON —
        scrapeable as-is."""
        from kubernetes_autoscaler_tpu_torch.metrics.metrics import default_registry

        return self.registry.expose_text() + default_registry.expose_text()

    # ---- rpc: Explain ----

    def explain(self, payload: bytes = b"", tenant: str = "") -> dict:
        """The sidecar's per-tenant lineage surface (docs/LINEAGE.md): the
        tenant's TenantJournal ring — every ApplyDelta and sim verdict
        digest, chained — returned ROW-FOR-ROW (the Metricz ≡ /metrics
        parity contract: tests pin Explain records == ts.journal.snapshot()
        exactly). Optional body `{"kinds": [...], "limit": N}` filters by
        record kind / keeps the newest N rows, with `held`/`returned`
        accounting so a filtered reply never masquerades as the full ring.
        Pure read under the ring's own lock — no dispatch, no encode."""
        req = {}
        if payload:
            try:
                req = json.loads(payload.decode() or "{}")
            except ValueError:
                return {"error": "malformed Explain body (want JSON)"}
        self.registry.counter(
            "lineage_queries_total",
            help="Lineage queries served, by surface").inc(surface="explain")
        ts = self._tenant_peek(tenant)
        if ts is None:
            return {"tenant": tenant or "default", "found": False,
                    "records": [], "held": 0, "returned": 0}
        if ts.journal is None:
            return {"tenant": tenant or "default", "found": True,
                    "journal": None, "records": [], "held": 0,
                    "returned": 0}
        rows = ts.journal.snapshot()
        held = len(rows)
        kinds = req.get("kinds")
        if kinds:
            rows = [r for r in rows if r.get("kind") in set(kinds)]
        limit = req.get("limit")
        if isinstance(limit, int) and limit >= 0:
            rows = rows[-limit:] if limit else []
        return {"tenant": tenant or "default", "found": True,
                "records": rows, "held": held, "returned": len(rows),
                "cursor": list(ts.journal.cursor() or ()) or None,
                "stats": ts.journal.stats()}


def traced_call(service: SimulatorService, method: str, fn,
                trace_id: str | None = None, tenant: str = "",
                sample: bool = True):
    """Run one RPC body under the sidecar's observability contract: RPC
    count/duration always land in `service.registry` (labelled with the
    tenant when one was identified — stale tenant labels are zeroed by
    drop_tenant); when the caller stamped a trace id into the request
    metadata, the body runs under a child Tracer with the SAME id and the
    closed spans come back as the `(result, trace_group)` second element —
    the shape `metrics/trace.Tracer.add_remote_spans` merges client-side,
    so one trace covers both processes.

    With `sample` (simulation RPCs), the body ALWAYS runs under a tracer —
    a fresh server-side id when the client stamped none — and the completed
    trace is OFFERED to the tail sampler (service._on_complete): slow /
    failed / backpressured / SLO-breaching requests are retained with their
    full lifecycle span tree, and the retained trace id lands as the
    latency histogram bucket's exemplar. Unsampled requests cost one
    snapshot + a reservoir append."""
    own_id = sample and trace_id is None
    tracer = (trace.Tracer(trace_id=trace_id, process="sidecar")
              if (trace_id or sample) else None)
    prev = trace.activate(tracer) if tracer is not None else None
    t0 = _time.perf_counter()
    error: Exception | None = None
    try:
        if tracer is not None:
            idx = tracer.begin(f"sidecar/{method}", cat="sidecar",
                               **({"tenant": tenant} if tenant else {}))
            try:
                out = fn()
            finally:
                ts = service._tenant_peek(tenant)
                tracer.end(
                    idx, version=ts.state.version if ts is not None else 0)
        else:
            out = fn()
    except Exception as e:
        error = e
        raise
    finally:
        if tracer is not None:
            trace.activate(prev)
        dt = _time.perf_counter() - t0
        exemplar = (service._on_complete(method, tenant, dt, tracer,
                                         error=error)
                    if sample else None)
        labels = {"method": method}
        if tenant:
            labels["tenant"] = tenant
        service.registry.counter(
            "rpc_total", help="RPCs served, by method").inc(**labels)
        service.registry.histogram(
            "rpc_duration_seconds", help="Server-side RPC wall clock",
            buckets=PHASE_BUCKETS).observe(dt, exemplar=exemplar, **labels)
    group = None
    if tracer is not None and not own_id:
        # span report-back only when the CLIENT is tracing (it stamped the
        # id); a server-side sampling tracer stays server-side
        snap = tracer.snapshot()
        group = {"trace_id": snap["trace_id"], "process": "sidecar",
                 "spans": snap["spans"]}
    return out, group


def make_grpc_server(service: SimulatorService, port: int = 50151,
                     cert_file: str | None = None,
                     key_file: str | None = None,
                     client_ca_file: str | None = None,
                     host: str = "127.0.0.1",
                     max_workers: int = 16):
    """Wire the service into a grpc.Server with generic bytes handlers.

    TLS: pass cert_file/key_file to serve over TLS (mirrors the reference's
    --grpc-expander-cert precedent for out-of-process plugins; round-3 review
    item #7 — the simulator service previously bound insecure only).
    client_ca_file additionally requires and verifies client certificates
    (mTLS). Without certs the server binds insecure on localhost.

    `max_workers` bounds concurrently blocked handler threads — it must
    comfortably exceed the batch lane count or the coalescing window can
    never fill (handlers park on their tickets while a window forms)."""
    import grpc

    def _meta_of(context, key: str) -> str | None:
        md = getattr(context, "invocation_metadata", None)
        if md is None:
            return None
        for k, v in md() or ():
            if k == key:
                return v
        return None

    def _reject(context, e: Exception, code, code_name: str,
                retry_after_ms: int | None = None,
                reason: str | None = None) -> bytes:
        # explicit structured rejection: the caller sees a REAL status code
        # (RESOURCE_EXHAUSTED backpressure / FAILED_PRECONDITION quarantine
        # / INVALID_ARGUMENT validation / UNAVAILABLE dead scheduler)
        # instead of a wedged RPC or an anonymous error string
        try:
            if retry_after_ms is not None:
                context.set_trailing_metadata(
                    ((RETRY_AFTER_MS_HEADER, str(retry_after_ms)),))
            context.set_code(code)
            context.set_details(str(e))
        except Exception:  # noqa: BLE001 — non-grpc contexts in tests
            pass
        body = {"error": str(e), "code": code_name}
        if retry_after_ms is not None:
            body["retry_after_ms"] = retry_after_ms
        if reason is not None:
            body["reason"] = reason
        return json.dumps(body).encode()

    def _json_method(name: str, fn, parse_params: bool, sample: bool = True):
        def handler(request: bytes, context):
            tenant = _meta_of(context, TENANT_ID_HEADER) or ""
            budget = _meta_of(context, SLO_BUDGET_MS_HEADER)
            if budget:
                # the client declares its own loop deadline as the tenant's
                # latency budget (last write wins)
                try:
                    service.slo.set(tenant, float(budget))
                except ValueError:
                    pass
            try:
                if parse_params:
                    raw = json.loads(request.decode() or "{}")
                    params = SimParams(
                        max_new_nodes=raw.get("max_new_nodes", 256),
                        strategy=raw.get("strategy", "least-waste"),
                        threshold=raw.get("threshold", 0.5),
                        node_groups=raw.get("node_groups"),
                    )
                    body = lambda: fn(params, tenant=tenant)  # noqa: E731
                elif name == "ApplyDelta":
                    base = _meta_of(context, BASE_VERSION_HEADER)
                    kw = ({"base_version": int(base)}
                          if base not in (None, "") else {})
                    body = lambda: fn(request, tenant=tenant, **kw)  # noqa: E731
                else:
                    body = lambda: fn(request, tenant=tenant)  # noqa: E731
                resp, group = traced_call(
                    service, name, body,
                    trace_id=_meta_of(context, TRACE_ID_HEADER),
                    tenant=tenant, sample=sample)
                if group is not None and isinstance(resp, dict):
                    resp["trace"] = group
                if faults.PLAN is not None:
                    faults.PLAN.fire("grpc_reply", tenant=tenant,
                                     registry=service.registry)
                return json.dumps(resp).encode()
            except QueueFull as e:
                return _reject(context, e, grpc.StatusCode.RESOURCE_EXHAUSTED,
                               "RESOURCE_EXHAUSTED",
                               retry_after_ms=e.retry_after_ms)
            except Quarantined as e:
                return _reject(context, e, grpc.StatusCode.FAILED_PRECONDITION,
                               "FAILED_PRECONDITION",
                               retry_after_ms=e.retry_after_ms,
                               reason=e.reason)
            except WorldValidationError as e:
                return _reject(context, e, grpc.StatusCode.INVALID_ARGUMENT,
                               "INVALID_ARGUMENT", reason=e.reason)
            except SchedulerDown as e:
                return _reject(context, e, grpc.StatusCode.UNAVAILABLE,
                               "UNAVAILABLE")
            except Exception as e:  # fail-closed with the error on the wire
                return json.dumps({"error": str(e)}).encode()

        return handler

    def _metricz(request: bytes, context):
        text, _ = traced_call(service, "Metricz", service.metricz,
                              trace_id=_meta_of(context, TRACE_ID_HEADER),
                              sample=False)
        return text.encode()

    def _statusz(request: bytes, context):
        text, _ = traced_call(service, "Statusz", service.statusz,
                              trace_id=_meta_of(context, TRACE_ID_HEADER),
                              sample=False)
        return text.encode()

    def _profilez(request: bytes, context):
        resp, _ = traced_call(service, "Profilez",
                              lambda: service.profilez(request),
                              trace_id=_meta_of(context, TRACE_ID_HEADER),
                              sample=False)
        return json.dumps(resp).encode()

    ident = lambda b: b

    method_handlers = {
        "ApplyDelta": grpc.unary_unary_rpc_method_handler(
            _json_method("ApplyDelta", service.apply_delta, False,
                         sample=False),
            request_deserializer=ident, response_serializer=ident),
        "ScaleUpSim": grpc.unary_unary_rpc_method_handler(
            _json_method("ScaleUpSim", service.scale_up_sim, True),
            request_deserializer=ident, response_serializer=ident),
        "ScaleDownSim": grpc.unary_unary_rpc_method_handler(
            _json_method("ScaleDownSim", service.scale_down_sim, True),
            request_deserializer=ident, response_serializer=ident),
        "WhatIf": grpc.unary_unary_rpc_method_handler(
            _json_method("WhatIf", service.what_if, False),
            request_deserializer=ident, response_serializer=ident),
        "Health": grpc.unary_unary_rpc_method_handler(
            _json_method("Health", lambda _b, tenant="": service.health(),
                         False, sample=False),
            request_deserializer=ident, response_serializer=ident),
        "Explain": grpc.unary_unary_rpc_method_handler(
            _json_method("Explain", service.explain, False, sample=False),
            request_deserializer=ident, response_serializer=ident),
        "Metricz": grpc.unary_unary_rpc_method_handler(
            _metricz, request_deserializer=ident, response_serializer=ident),
        "Statusz": grpc.unary_unary_rpc_method_handler(
            _statusz, request_deserializer=ident, response_serializer=ident),
        "Profilez": grpc.unary_unary_rpc_method_handler(
            _profilez, request_deserializer=ident,
            response_serializer=ident),
    }
    from concurrent.futures import ThreadPoolExecutor

    server = grpc.server(ThreadPoolExecutor(
        max_workers=max(max_workers, 2 * service.batch_lanes or 4)))
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_SERVICE, method_handlers),)
    )
    if client_ca_file and not (cert_file and key_file):
        raise ValueError(
            "client_ca_file (mTLS) requires a serving cert_file/key_file — "
            "refusing to bind insecure while client verification was asked")
    if cert_file and key_file:
        with open(key_file, "rb") as f:
            key = f.read()
        with open(cert_file, "rb") as f:
            crt = f.read()
        root = None
        if client_ca_file:
            with open(client_ca_file, "rb") as f:
                root = f.read()
        creds = grpc.ssl_server_credentials(
            [(key, crt)], root_certificates=root,
            require_client_auth=bool(client_ca_file))
        bound = server.add_secure_port(f"{host}:{port}", creds)
    else:
        bound = server.add_insecure_port(f"{host}:{port}")
    return server, bound


class CircuitOpen(ConnectionError):
    """Fast-fail from an OPEN client circuit: the sidecar kept failing, so
    this call never touched the wire — one exception per loop instead of a
    full retry ladder per RPC against a flapping server. Carries the error
    that opened the circuit and the time until the next half-open probe."""

    def __init__(self, retry_in_s: float, last_error: Exception | None):
        super().__init__(
            f"sidecar circuit open (half-open probe in {retry_in_s:.2f}s); "
            f"last error: {last_error!r}")
        self.retry_in_s = retry_in_s
        self.last_error = last_error


class CircuitBreaker:
    """closed → open → half-open client circuit (docs/ROBUSTNESS.md).

    closed: calls flow; `threshold` CONSECUTIVE transport failures
    (UNAVAILABLE after the retry ladder, deadline exceeded) open it.
    open: calls fast-fail with CircuitOpen until `cooldown_s` elapses.
    half-open: exactly one probe (the client uses the cheap Health RPC) is
    allowed through; success closes the circuit, failure re-opens it for
    another cooldown. Responses that prove the server ALIVE — including
    backpressure rejections — reset the failure streak.

    State changes land on the default metrics registry
    (`sidecar_breaker_state{target}` 0/1/2 and
    `sidecar_breaker_transitions_total{target,to}`) so a flapping sidecar
    is visible from the control plane's own /metrics. `clock` is
    injectable for fake-clock tests."""

    STATES = {"closed": 0, "open": 1, "half-open": 2}

    def __init__(self, threshold: int = 5, cooldown_s: float = 1.0,
                 clock=_time.monotonic, target: str = ""):
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self.target = target
        self.state = "closed"
        self.failures = 0
        self.last_error: Exception | None = None
        self._opened_at = 0.0
        self._lock = threading.Lock()

    def _to(self, state: str) -> None:
        if state == self.state:
            return
        self.state = state
        from kubernetes_autoscaler_tpu_torch.metrics.metrics import default_registry

        labels = {"target": self.target} if self.target else {}
        default_registry.gauge(
            "sidecar_breaker_state",
            help="Client circuit-breaker state per sidecar target "
                 "(0=closed 1=open 2=half-open)",
        ).set(float(self.STATES[state]), **labels)
        default_registry.counter(
            "sidecar_breaker_transitions_total",
            help="Client circuit-breaker state transitions",
        ).inc(to=state, **labels)

    def gate(self) -> str:
        """'ok' to call through, 'probe' to health-check first (half-open);
        raises CircuitOpen while the circuit is open and cooling."""
        with self._lock:
            if self.state == "closed":
                return "ok"
            elapsed = self._clock() - self._opened_at
            if self.state == "open" and elapsed < self.cooldown_s:
                raise CircuitOpen(self.cooldown_s - elapsed, self.last_error)
            self._to("half-open")
            return "probe"

    def ok(self) -> None:
        """The server answered (a sim result, or even a structured
        rejection): the streak resets and a half-open circuit closes."""
        with self._lock:
            self.failures = 0
            if self.state != "closed":
                self._to("closed")

    def fail(self, error: Exception) -> None:
        """A transport-level failure: half-open re-opens immediately, a
        closed circuit opens once the consecutive streak hits threshold."""
        with self._lock:
            self.last_error = error
            self.failures += 1
            if self.state == "half-open" or self.failures >= self.threshold:
                self._to("open")
                self._opened_at = self._clock()


class SimulatorClient:
    """Thin client mirroring the Go side's calls (tests + examples).

    Resilience contract (ISSUE 7 small fix): every RPC carries a per-call
    DEADLINE (`rpc_timeout_s`) and UNAVAILABLE errors — the sidecar
    restarting or the channel flapping — are retried with exponential
    backoff, capped BOTH by attempts (`retry_attempts`) and by a TOTAL
    wall-clock budget (`retry_budget_s`, the InitBudget pattern: the ladder
    never sleeps past the deadline; a persistently refused connection fails
    in under a second). When the cap is hit the last error raises promptly,
    so a control loop using the sidecar degrades to its LOCAL simulation
    fallback instead of hanging a RunOnce forever.

    Backpressure (RESOURCE_EXHAUSTED) now honors the server's
    `katpu-retry-after-ms` hint (ISSUE 12 small fix): up to
    `queue_retry_attempts` jittered, capped sleeps before surfacing
    admission.QueueFull — the hint is what the server computed the queue
    needs, so blind-fast retry (hammering a saturated server) and
    terminal-give-up (shedding load the queue would have absorbed in 20ms)
    are both wrong. Deliberate immediate shedding is still available with
    `queue_retry_attempts=0`.

    On top of the per-RPC ladder sits a real CIRCUIT BREAKER
    (docs/ROBUSTNESS.md): `breaker_threshold` consecutive transport
    failures open it, after which calls fast-fail with CircuitOpen (no
    wire touch) until `breaker_cooldown_s` elapses; the half-open probe is
    the cheap Health RPC, so a flapping sidecar costs one fast exception
    per loop instead of a full retry ladder per RPC. `clock`/`sleep` are
    injectable for fake-clock tests."""

    def __init__(self, port: int, cert_file: str | None = None,
                 host: str = "127.0.0.1",
                 client_cert_file: str | None = None,
                 client_key_file: str | None = None,
                 tenant: str = "",
                 rpc_timeout_s: float = 30.0,
                 retry_budget_s: float = 10.0,
                 retry_attempts: int = 5,
                 slo_budget_ms: float = 0.0,
                 queue_retry_attempts: int = 3,
                 queue_retry_cap_ms: float = 2000.0,
                 breaker_threshold: int = 5,
                 breaker_cooldown_s: float = 1.0,
                 clock=_time.monotonic,
                 sleep=_time.sleep):
        import grpc
        import random as _random

        self.tenant = tenant
        self.rpc_timeout_s = rpc_timeout_s
        self.retry_budget_s = retry_budget_s
        self.retry_attempts = retry_attempts
        self.queue_retry_attempts = max(int(queue_retry_attempts), 0)
        self.queue_retry_cap_ms = float(queue_retry_cap_ms)
        self._clock = clock
        self._sleep = sleep
        # full jitter over the server hint: a deterministic per-client seed
        # keeps chaos runs replayable (the jitter exists to decorrelate a
        # HERD of clients, not to randomize one client's evidence)
        self._rng = _random.Random(0x5EED)
        # breaker_threshold=0 disables the breaker (raw ladder semantics)
        self.breaker = (CircuitBreaker(
            threshold=breaker_threshold, cooldown_s=breaker_cooldown_s,
            clock=clock, target=f"{host}:{port}")
            if breaker_threshold > 0 else None)
        # declared per-tenant latency budget (wire.SLO_BUDGET_MS_HEADER):
        # the server counts tenant_slo_breaches_total against it and keeps
        # tenant-scoped breach dumps
        self.slo_budget_ms = float(slo_budget_ms)
        # server-side lifecycle block of the most recent sim RPC (queue vs
        # dispatch vs harvest decomposition; RunOnce consumers read it to
        # separate server time from network time)
        self.last_lifecycle: dict | None = None
        if cert_file:
            with open(cert_file, "rb") as f:
                root = f.read()
            ck = cc = None
            if client_cert_file and client_key_file:
                with open(client_key_file, "rb") as f:
                    ck = f.read()
                with open(client_cert_file, "rb") as f:
                    cc = f.read()
            creds = grpc.ssl_channel_credentials(
                root_certificates=root, private_key=ck, certificate_chain=cc)
            # loopback targets verify against the self-signed pair's
            # "localhost" SAN; real hosts verify their own names — never
            # weaken verification for them
            opts = ([("grpc.ssl_target_name_override", "localhost")]
                    if host in ("127.0.0.1", "::1", "localhost") else [])
            self.channel = grpc.secure_channel(
                f"{host}:{port}", creds, options=opts)
        else:
            self.channel = grpc.insecure_channel(f"{host}:{port}")

    @staticmethod
    def _retry_after_ms(err) -> int:
        try:
            for k, v in err.trailing_metadata() or ():
                if k == RETRY_AFTER_MS_HEADER:
                    return int(v)
        except Exception:  # noqa: BLE001
            pass
        return 20

    def _probe_health(self) -> None:
        """The half-open probe: ONE cheap Health RPC, no retry ladder. A
        SERVING answer closes the breaker and lets the real call proceed; a
        failure (or NOT_SERVING) re-opens it for another cooldown and
        fast-fails the caller."""
        rpc = self.channel.unary_unary(
            f"/{_SERVICE}/Health",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        try:
            resp = json.loads(rpc(b"", timeout=min(self.rpc_timeout_s, 2.0)))
            if resp.get("status", "SERVING") == "NOT_SERVING":
                raise ConnectionError(
                    f"sidecar NOT_SERVING: {resp.get('error')}")
            self.breaker.ok()
        except Exception as e:  # noqa: BLE001 — any probe failure re-opens
            self.breaker.fail(e)
            raise CircuitOpen(self.breaker.cooldown_s, e) from e

    def _call(self, method: str, payload: bytes, metadata=()) -> bytes:
        import grpc

        rpc = self.channel.unary_unary(
            f"/{_SERVICE}/{method}",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        # circuit gate BEFORE any wire touch: open = one fast exception
        # (the caller's local-fallback signal), half-open = Health probe
        if self.breaker is not None:
            tracer0 = trace.current_tracer()
            try:
                if self.breaker.gate() == "probe":
                    self._probe_health()
            except CircuitOpen:
                if tracer0 is not None:
                    tracer0.annotate(breaker="open")
                raise
        # trace propagation: the ACTIVE tracer's id rides request metadata
        # (never the payload bytes — the KAD1 wire contract stays trace-free)
        # and the rpc itself is a client-side span on the same timeline;
        # tenant identity rides the same way (wire.TENANT_ID_HEADER)
        tracer = trace.current_tracer()
        md = list(metadata)
        if tracer is not None:
            md.append((TRACE_ID_HEADER, tracer.trace_id))
        if self.tenant:
            md.append((TENANT_ID_HEADER, self.tenant))
        if self.slo_budget_ms > 0:
            md.append((SLO_BUDGET_MS_HEADER, str(self.slo_budget_ms)))

        def invoke():
            deadline = self._clock() + self.retry_budget_s
            delay = 0.05
            for attempt in range(max(self.retry_attempts, 1)):
                try:
                    return rpc(payload, timeout=self.rpc_timeout_s,
                               metadata=tuple(md) or None)
                except grpc.RpcError as e:
                    code = e.code()
                    if code == grpc.StatusCode.RESOURCE_EXHAUSTED:
                        raise QueueFull(None, self._retry_after_ms(e)) from e
                    if (code != grpc.StatusCode.UNAVAILABLE
                            or attempt + 1 >= self.retry_attempts
                            or self._clock() + delay >= deadline):
                        raise   # cap hit: degrade, don't hang
                    self._sleep(delay)
                    delay = min(delay * 2, 1.0)

        def attempt():
            """invoke() + breaker accounting + the retry-after contract:
            backpressure sleeps the server's hint (full jitter, capped)
            up to queue_retry_attempts times — neither terminal nor blind."""
            import grpc as _grpc

            for qa in range(self.queue_retry_attempts + 1):
                try:
                    out = invoke()
                    if self.breaker is not None:
                        self.breaker.ok()
                    return out
                except QueueFull as e:
                    if self.breaker is not None:
                        self.breaker.ok()   # the server ANSWERED: alive
                    if qa >= self.queue_retry_attempts:
                        raise
                    hint_ms = max(e.retry_after_ms, 1)
                    wait_ms = min(hint_ms * (1.0 + self._rng.random()),
                                  self.queue_retry_cap_ms)
                    if tracer is not None:
                        tracer.bump("queue_retries")
                    self._sleep(wait_ms / 1000.0)
                except _grpc.RpcError as e:
                    if self.breaker is not None and e.code() in (
                            _grpc.StatusCode.UNAVAILABLE,
                            _grpc.StatusCode.DEADLINE_EXCEEDED):
                        self.breaker.fail(e)
                    raise

        if tracer is None:
            return attempt()
        with tracer.span(f"rpc/{method}", cat="rpc", bytes=len(payload)):
            return attempt()

    def _call_json(self, method: str, payload: bytes, metadata=()) -> dict:
        t0 = _time.perf_counter()
        resp = json.loads(self._call(method, payload, metadata=metadata))
        rpc_wall_ms = (_time.perf_counter() - t0) * 1000.0
        # the server reports its child spans back in the response; merge
        # them so ONE trace covers both processes
        tracer = trace.current_tracer()
        group = resp.pop("trace", None) if isinstance(resp, dict) else None
        if tracer is not None and group is not None:
            tracer.add_remote_spans(group)
        # the server's lifecycle decomposition: annotate the caller's trace
        # so a RunOnce timeline shows server-side queue time DISTINCT from
        # network time (client rpc wall minus server e2e ≈ wire +
        # serialization). Kept off the returned payload — consumers read
        # `last_lifecycle`, response dicts stay sim results only.
        lc = resp.pop("lifecycle", None) if isinstance(resp, dict) else None
        if lc is not None:
            lc["net_ms"] = round(max(rpc_wall_ms - lc.get("e2e_ms", 0.0), 0.0), 4)
            self.last_lifecycle = lc
            if tracer is not None:
                tracer.annotate(
                    server_e2e_ms=lc.get("e2e_ms"), net_ms=lc["net_ms"],
                    server_queue_ms=lc.get("phases_ms", {}).get("queue"))
        return resp

    def apply_delta(self, writer: DeltaWriter,
                    base_version: int | None = None) -> dict:
        """`base_version` pins the snapshot version this delta was built
        against (wire.BASE_VERSION_HEADER): a restarted/rehydrated server
        holding a different version rejects INVALID_ARGUMENT
        (section-version-mismatch) — the full-resend signal — instead of
        applying the delta to the wrong base."""
        md = (((BASE_VERSION_HEADER, str(int(base_version))),)
              if base_version is not None else ())
        return self._call_json("ApplyDelta", writer.payload(), metadata=md)

    def scale_up_sim(self, **params) -> dict:
        return self._call_json("ScaleUpSim", json.dumps(params).encode())

    def scale_down_sim(self, **params) -> dict:
        return self._call_json("ScaleDownSim", json.dumps(params).encode())

    def what_if(self, variants=(), rollout: int = 0, workload=None,
                **params) -> dict:
        """Counterfactual multiverse over the tenant's resident world
        (docs/WHATIF.md): `variants` is a list of variant dicts (lane 0
        null hypothesis is always prepended server-side), `rollout` a
        simulated loop count (0 = single step), `workload` a
        WorkloadSpec record dict for the rollout's synthetic traffic."""
        body = dict(params)
        body["variants"] = [v.to_dict() if hasattr(v, "to_dict") else v
                            for v in variants]
        body["rollout"] = rollout
        if workload is not None:
            body["workload"] = (workload.to_record()
                                if hasattr(workload, "to_record")
                                else workload)
        return self._call_json("WhatIf", json.dumps(body).encode())

    def health(self) -> dict:
        return self._call_json("Health", b"")

    def explain(self, kinds=None, limit: int | None = None) -> dict:
        """This tenant's TenantJournal lineage rows (the Explain RPC;
        row-for-row the server ring's snapshot unless filtered)."""
        body = {}
        if kinds:
            body["kinds"] = list(kinds)
        if limit is not None:
            body["limit"] = int(limit)
        return self._call_json("Explain",
                               json.dumps(body).encode() if body else b"")

    def metricz(self) -> str:
        """Prometheus text of the sidecar's Registry (rpc counters etc.)."""
        return self._call("Metricz", b"").decode()

    def statusz(self) -> str:
        """Human-readable serving snapshot (tenant table, queue, shape
        classes, dispatch gaps, tail-sampler budget)."""
        return self._call("Statusz", b"").decode()

    def profilez(self, arm: bool = False, reason: str = "manual") -> dict:
        """Device-profiler state; `arm=True` arms a capture of the NEXT
        sim dispatch (the /snapshotz armed-handle pattern, rate-limited)."""
        return self._call_json(
            "Profilez", json.dumps({"arm": arm, "reason": reason}).encode())


def main(argv=None):
    """Standalone sidecar: python -m kubernetes_autoscaler_tpu_torch.sidecar.server
    --port 50151 [--batch-lanes 8 --batch-window-ms 2 --queue-depth 128]
    [--grpc-cert C --grpc-key K [--grpc-client-ca CA]]
    [--self-signed-cert-dir DIR]."""
    import argparse
    import time

    ap = argparse.ArgumentParser(prog="katpu-sidecar")
    ap.add_argument("--port", type=int, default=50151)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--batch-lanes", type=int, default=8,
                    help="multi-tenant coalesced dispatch width (0 = serial "
                         "per-RPC dispatch)")
    ap.add_argument("--batch-window-ms", type=float, default=2.0,
                    help="coalescing window: how long a dispatch waits for "
                         "concurrent requests to join its batch")
    ap.add_argument("--batch-window-max", type=int, default=0,
                    help="coalescing cap: tickets collected per window "
                         "before it closes early (0 = 4x batch-lanes); each "
                         "window then chunks into lane-width dispatches")
    ap.add_argument("--queue-depth", type=int, default=128,
                    help="admission bound; beyond it requests are rejected "
                         "with RESOURCE_EXHAUSTED + retry-after")
    ap.add_argument("--checkpoint-dir", default="",
                    help="warm-restart state dir: rehydrate per-tenant "
                         "serving records from here at startup and persist "
                         "them on graceful shutdown (SIGTERM/SIGINT) — a "
                         "restarted sidecar serves steady tenants without "
                         "full world re-sends (docs/ROBUSTNESS.md)")
    ap.add_argument("--quarantine-ttl-s", type=float, default=30.0,
                    help="poison-tenant quarantine sentence before "
                         "auto-parole")
    ap.add_argument("--hbm-budget-frac", type=float, default=0.0,
                    help="HBM admission budget as a fraction of the device "
                         "memory limit: a new tenant whose projected "
                         "residency would push tagged bytes past it is "
                         "rejected with the hbm-budget validation reason "
                         "(0 = gate off)")
    ap.add_argument("--hbm-limit-bytes", type=int, default=0,
                    help="budget denominator override for backends without "
                         "memory_stats (0 = use the device's bytes_limit)")
    ap.add_argument("--device-profile-dir", default="",
                    help="enable breach-triggered device profiling: SLO-"
                         "breach/tail-retained requests (or the Profilez "
                         "RPC) arm a bounded, rate-limited "
                         "torch.profiler capture into this directory, "
                         "stamped with the retained trace id + journal "
                         "cursor")
    ap.add_argument("--shadow-audit", action="store_true",
                    help="online shadow audit: one round-robin member "
                         "lane per batched window is re-simulated through "
                         "the serial reference program on a dedicated "
                         "worker and compared bit-for-bit — divergence is "
                         "surfaced as a backend fault (counter + event + "
                         "retained trace + tenant-journal persist), never "
                         "a tenant quarantine (docs/OBSERVABILITY.md "
                         "\"Shadow audit\")")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="the device every tenant's world and every sim "
                         "runs on (default: cuda)")
    ap.add_argument("--grpc-cert", default="")
    ap.add_argument("--grpc-key", default="")
    ap.add_argument("--grpc-client-ca", default="")
    ap.add_argument("--self-signed-cert-dir", default="",
                    help="generate+rotate a serving cert here when no "
                         "--grpc-cert is given (rotation rebinds the gRPC "
                         "listener — grpc credentials hold the PEM bytes)")
    args = ap.parse_args(argv)
    cm = None
    cert, key = args.grpc_cert, args.grpc_key
    if not cert and args.self_signed_cert_dir:
        from kubernetes_autoscaler_tpu_torch.utils.certs import CertManager

        cm = CertManager(args.self_signed_cert_dir, common_name="localhost")
        cert, key = cm.cert_path, cm.key_path
    service = SimulatorService(batch_lanes=args.batch_lanes,
                               batch_window_ms=args.batch_window_ms,
                               batch_window_max=args.batch_window_max or None,
                               queue_depth=args.queue_depth,
                               quarantine_ttl_s=args.quarantine_ttl_s,
                               rehydrate_dir=args.checkpoint_dir,
                               hbm_budget_frac=args.hbm_budget_frac,
                               hbm_limit_bytes=args.hbm_limit_bytes,
                               device_profile_dir=args.device_profile_dir,
                               shadow_audit=args.shadow_audit,
                               device=args.device)
    if args.checkpoint_dir and service.rehydration["restored"]:
        print(f"katpu-sidecar rehydrated "
              f"{service.rehydration['restored']} tenants from "
              f"{args.checkpoint_dir} "
              f"(digest_mismatch={service.rehydration['digest_mismatch']})",
              flush=True)
    # graceful termination checkpoints the tenant table: SIGTERM (the
    # orchestrated shutdown path) raises into the KeyboardInterrupt branch
    import signal

    def _term(_sig, _frm):
        raise KeyboardInterrupt

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:   # pragma: no cover — non-main-thread embedding
        pass

    def bind():
        srv, bound = make_grpc_server(
            service, args.port, cert_file=cert or None, key_file=key or None,
            client_ca_file=args.grpc_client_ca or None, host=args.host)
        srv.start()
        return srv, bound

    server, bound = bind()
    print(f"katpu-sidecar listening on {args.host}:{bound} "
          f"({'tls' if cert else 'insecure'}; "
          f"batch_lanes={args.batch_lanes})", flush=True)
    try:
        while True:
            time.sleep(3600)
            if cm is not None and cm.ensure():
                # rotated: grpc server credentials are immutable — rebind
                # with the fresh pair (the snapshot state lives in `service`
                # and survives the rebind)
                server.stop(5.0).wait()
                server, bound = bind()
                print(f"katpu-sidecar rotated serving cert; rebound on "
                      f"{args.host}:{bound}", flush=True)
    except KeyboardInterrupt:
        server.stop(2.0)
        if args.checkpoint_dir:
            ck = service.checkpoint(args.checkpoint_dir)
            print(f"katpu-sidecar checkpointed {ck['tenants']} tenants to "
                  f"{args.checkpoint_dir}", flush=True)
        service.close()


if __name__ == "__main__":
    main()

"""Scale-down actuator: taint, drain, delete.

Reference counterpart: core/scaledown/actuation/ — StartDeletion
(actuator.go): apply the ToBeDeleted taint, evict pods with per-node goroutine
parallelism under budgets (budgets.go, --max-scale-down-parallelism /
--max-drain-parallelism), batch empty-node deletions per group
(delete_in_batch.go), and track in-flight deletions
(deletiontracker/nodedeletiontracker.go).

Eviction here goes through the EvictionSink seam (the kube API in the
reference; the fake cluster in tests; the sidecar's control plane in
deployment) so the actuator logic is transport-independent.
"""

from __future__ import annotations

import concurrent.futures
import copy
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Protocol

from kubernetes_autoscaler_tpu_torch.cloudprovider.provider import (
    CloudProvider,
    NodeGroupError,
)
from kubernetes_autoscaler_tpu_torch.config.options import AutoscalingOptions
from kubernetes_autoscaler_tpu_torch.core.scaledown.planner import NodeToRemove
from kubernetes_autoscaler_tpu_torch.models.api import (
    DELETION_CANDIDATE_TAINT,
    TO_BE_DELETED_TAINT,
    Node,
    Pod,
    Taint,
)


# reference: actuation/drain.go:44-49 — retry cadence for failed evictions and
# the extra wait for pods ignoring SIGTERM (killed at grace-period expiry)
DEFAULT_EVICTION_RETRY_TIME_S = 10.0
DEFAULT_POD_EVICTION_HEADROOM_S = 30.0
# apiv1.DefaultTerminationGracePeriodSeconds
DEFAULT_TERMINATION_GRACE_S = 30.0
# how long an eviction counts as "recent" for planner re-injection
# (reference: NewNodeDeletionTracker(15*time.Minute), builder wiring)
DEFAULT_EVICTIONS_TTL_S = 900.0


class EvictionSink(Protocol):
    """Where evictions land (reference: the eviction API in actuation/drain.go).

    `evict` may RAISE to signal a failed eviction (PDB conflict, API error);
    the actuator retries until --max-pod-eviction-time elapses
    (drain.go:185,240). Optional extensions a sink may provide:
      force_delete(pod, node)      — bypass eviction (reference
                                     forceDeletePod, drain.go:295)
      pods_gone(node_name, pod_names) -> bool
                                   — poll hook for the post-eviction wait
                                     (drain.go allGone loop); sinks whose
                                     evict() is synchronous can omit it
    """

    def evict(self, pod: Pod, node: Node, grace_period_s: float | None = None
              ) -> None: ...


@dataclass
class DeletionResult:
    node: str
    ok: bool
    reason: str = ""


def priority_eviction_order(pods: list[Pod]) -> list[Pod]:
    """reference: actuation/priority.go priority evictor — evict in ascending
    pod-priority tiers so high-priority pods keep running until lower tiers
    have been asked to leave (the reference additionally waits between tiers;
    here tier completion is the sink's concern — evictions are issued in tier
    order)."""
    return sorted(pods, key=lambda p: p.priority)


@dataclass
class NodeDeletionTracker:
    """reference: deletiontracker/nodedeletiontracker.go — in-flight deletion
    registry + recent-eviction registry (RegisterEviction :125,
    RecentEvictions :132 with the expiring-list TTL). Lock-protected: drains
    run in worker threads and detached deletions span loops, so the control
    loop reads this concurrently with the workers' writes."""

    deleting: dict[str, float] = field(default_factory=dict)
    drained: set[str] = field(default_factory=set)   # subset of `deleting` with pods
    results: list[DeletionResult] = field(default_factory=list)
    evictions_ttl_s: float = DEFAULT_EVICTIONS_TTL_S
    _evictions: list[tuple[Pod, float]] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def start(self, node: str, now: float, drain: bool = False) -> None:
        with self._lock:
            self.deleting[node] = now
            if drain:
                self.drained.add(node)

    def finish(self, node: str, ok: bool, reason: str = "") -> None:
        with self._lock:
            self.deleting.pop(node, None)
            self.drained.discard(node)
            self.results.append(DeletionResult(node, ok, reason))

    def in_flight(self) -> int:
        with self._lock:
            return len(self.deleting)

    def is_deleting(self, node: str) -> bool:
        with self._lock:
            return node in self.deleting

    def drain_deletions_in_progress(self) -> list[str]:
        """Names of nodes currently being DRAINED (reference:
        DeletionsInProgress()'s second return — the set the
        currently-drained-nodes pod list processor consumes)."""
        with self._lock:
            return sorted(self.drained)

    def register_eviction(self, pod: Pod, now: float) -> None:
        """reference: RegisterEviction — called per successfully evicted pod
        so the planner can anticipate its recreation (planner.go:230-260)."""
        with self._lock:
            self._evictions.append((pod, now))

    def recent_evictions(self, now: float) -> list[Pod]:
        """Pods evicted within evictions_ttl_s (reference: RecentEvictions,
        expiring-list DropNotNewerThan prune on read)."""
        with self._lock:
            cutoff = now - self.evictions_ttl_s
            self._evictions = [(p, t) for p, t in self._evictions if t > cutoff]
            return [p for p, _ in self._evictions]


class Actuator:
    def __init__(
        self,
        provider: CloudProvider,
        options: AutoscalingOptions,
        eviction_sink: EvictionSink | None = None,
        on_taint: Callable[[Node, str], None] | None = None,
        pdb_tracker=None,
        latency_tracker=None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        on_result: Callable[[DeletionResult], None] | None = None,
        walltime: Callable[[], float] = time.time,
    ):
        self.provider = provider
        self.options = options
        self.eviction_sink = eviction_sink
        self.on_taint = on_taint
        self.tracker = NodeDeletionTracker()
        self.pdb_tracker = pdb_tracker          # core/scaledown/pdb.RemainingPdbTracker
        self.latency_tracker = latency_tracker  # core/scaledown/latencytracker
        self.clock = clock                      # injectable for retry tests
        self.sleep = sleep
        # the RunOnce `now` domain (wall clock in production, logical time in
        # harnesses): eviction timestamps must live in the SAME domain the
        # control loop prunes recent_evictions with — monotonic self.clock
        # would never line up with it
        self.walltime = walltime
        self.eviction_retry_time_s = DEFAULT_EVICTION_RETRY_TIME_S
        self.pod_eviction_headroom_s = DEFAULT_POD_EVICTION_HEADROOM_S
        self._sink_takes_grace: bool | None = None  # resolved on first evict
        # detached-deletion support (reference: deleteNodesAsync goroutines,
        # actuator.go:287 — deletions never block the control loop there).
        # on_result fires ON THE WORKER THREAD — notification only; all
        # bookkeeping belongs in drain_completed(), which the control loop
        # calls at the top of RunOnce (a callback that mutated
        # ClusterStateRegistry/observers/metrics off-thread would race)
        self.on_result = on_result
        self._bg: concurrent.futures.ThreadPoolExecutor | None = None
        self._completed: list[DeletionResult] = []
        self._completed_lock = threading.Lock()
        # live Node objects for deferred rollback (workers act on copies)
        self._live_nodes: dict[str, Node] = {}

    # ---- eviction with retry (reference: drain.go evictPod :240) ----

    def _grace_for(self, pod: Pod) -> float:
        """Grace period = pod's own, capped by --max-graceful-termination-sec
        (reference: evictPod maxTermination clamp, drain.go:243-249)."""
        g = (pod.termination_grace_s if pod.termination_grace_s is not None
             else DEFAULT_TERMINATION_GRACE_S)
        cap = self.options.max_graceful_termination_s
        if cap and cap > 0:
            g = min(g, cap)
        return g

    def _evict_once(self, pod: Pod, node: Node, grace_s: float) -> None:
        if self._sink_takes_grace is None:
            import inspect

            try:
                sig = inspect.signature(self.eviction_sink.evict)
                self._sink_takes_grace = "grace_period_s" in sig.parameters
            except (TypeError, ValueError):
                self._sink_takes_grace = False
        if self._sink_takes_grace:
            self.eviction_sink.evict(pod, node, grace_period_s=grace_s)
        else:  # minimal sinks only take (pod, node)
            self.eviction_sink.evict(pod, node)

    def _evict_with_retry(self, pod: Pod, node: Node, retry_until: float,
                          force: bool = False) -> None:
        """Retry eviction every eviction_retry_time_s until the
        --max-pod-eviction-time deadline (drain.go:185 retryUntil, :240 retry
        loop). Under force, a still-failing pod is force-deleted instead of
        failing the drain (drain.go:263 forceDeletePod)."""
        grace = self._grace_for(pod)
        last: Exception | None = None
        first = True
        while first or self.clock() < retry_until:
            if not first:
                self.sleep(self.eviction_retry_time_s)
            first = False
            try:
                self._evict_once(pod, node, grace)
                return
            except Exception as e:  # noqa: BLE001 — sink failure = retryable
                last = e
        if force:
            fd = getattr(self.eviction_sink, "force_delete", None)
            if fd is not None:
                fd(pod, node)
                return
        raise NodeGroupError(
            f"failed to evict pod {pod.namespace}/{pod.name} within allowed "
            f"timeout (last error: {last})")

    def _wait_pods_gone(self, node: Node, pods: list[Pod]) -> None:
        """Post-eviction wait: up to max-graceful-termination + headroom for
        the pods to actually terminate (drain.go allGone polling). Sinks
        without a pods_gone hook are synchronous by contract — no wait."""
        gone = getattr(self.eviction_sink, "pods_gone", None)
        if gone is None or not pods:
            return
        grace = max((self._grace_for(p) for p in pods), default=0.0)
        deadline = self.clock() + grace + self.pod_eviction_headroom_s
        names = [f"{p.namespace}/{p.name}" for p in pods]
        while True:
            if gone(node.name, names):
                return
            if self.clock() >= deadline:
                raise NodeGroupError(
                    f"pods remaining on {node.name} after termination timeout")
            self.sleep(min(self.eviction_retry_time_s, 5.0))

    # ---- taints (reference: utils/taints/taints.go) ----

    def taint_to_be_deleted(self, node: Node) -> None:
        if all(t.key != TO_BE_DELETED_TAINT for t in node.taints):
            node.taints.append(Taint(TO_BE_DELETED_TAINT, str(int(time.time())),
                                     "NoSchedule"))
        if self.on_taint:
            self.on_taint(node, TO_BE_DELETED_TAINT)

    def taint_deletion_candidate(self, node: Node, since: float | None = None) -> None:
        """Soft taint marking scale-down intent — the crash-recovery WAL
        (reference: softtaint.go + planner LoadFromExistingTaints). The taint
        value records when the node's unneeded CLOCK started, so a restarted
        process resumes the clock rather than restarting it."""
        if all(t.key != DELETION_CANDIDATE_TAINT for t in node.taints):
            node.taints.append(Taint(DELETION_CANDIDATE_TAINT,
                                     str(int(since if since is not None
                                             else time.time())),
                                     "PreferNoSchedule"))
        if self.on_taint:
            self.on_taint(node, DELETION_CANDIDATE_TAINT)

    def untaint(self, node: Node, key: str) -> None:
        node.taints = [t for t in node.taints if t.key != key]

    def _rollback_node(self, node: Node) -> None:
        """Failed deletion: remove the hard taint AND undo the cordon
        (reference: CleanToBeDeleted un-cordons on rollback when
        --cordon-node-before-terminating is set) so capacity is not lost."""
        self.untaint(node, TO_BE_DELETED_TAINT)
        if self.options.cordon_node_before_terminating:
            node.unschedulable = False

    # ---- deletion (reference: StartDeletion, actuator.go) ----

    def start_deletion(
        self,
        to_remove: list[NodeToRemove],
        pods_by_slot: dict[int, Pod] | None = None,
        now: float | None = None,
        detach: bool = False,
    ) -> list[DeletionResult]:
        """detach=True runs the evict+delete work on a background executor
        (the reference's deleteNodesAsync goroutines, actuator.go:287): the
        call taints the nodes and returns [] immediately; completed results
        flow through the tracker and the on_result callback. Synchronous
        mode (default) blocks until every node resolves — eviction retries
        can then hold RunOnce for up to --max-pod-eviction-time per pod,
        which is only acceptable with an in-process synchronous sink."""
        return self._start_deletion(to_remove, pods_by_slot, now, force=False,
                                    detach=detach)

    def start_force_deletion(
        self,
        to_remove: list[NodeToRemove],
        pods_by_slot: dict[int, Pod] | None = None,
        now: float | None = None,
    ) -> list[DeletionResult]:
        """Forced variant (reference: Actuator.StartForceDeletion,
        actuator.go:126): bypasses the PDB gate, force-deletes pods whose
        eviction keeps failing (drain.go:263), and deletes nodes via
        NodeGroup.force_delete_nodes (group_deletion_scheduler.go:105)."""
        return self._start_deletion(to_remove, pods_by_slot, now, force=True)

    def _start_deletion(
        self,
        to_remove: list[NodeToRemove],
        pods_by_slot: dict[int, Pod] | None,
        now: float | None,
        force: bool,
        detach: bool = False,
    ) -> list[DeletionResult]:
        # default into the SAME time domain register_eviction stamps with —
        # a logical-clock harness must not get wall-clock tracker.start()
        # timestamps next to logical eviction stamps
        now = self.walltime() if now is None else now
        if detach:
            # taints must land synchronously — the NEXT loop's planner and
            # filter-out-schedulable must see the nodes as leaving
            for r in to_remove:
                if self.options.cordon_node_before_terminating:
                    r.node.unschedulable = True
                self.taint_to_be_deleted(r.node)
                self.tracker.start(r.node.name, now, drain=not r.is_empty)
                self._live_nodes[r.node.name] = r.node
            if self._bg is None:
                self._bg = concurrent.futures.ThreadPoolExecutor(
                    max_workers=max(self.options.max_scale_down_parallelism,
                                    1),
                    thread_name_prefix="ka-delete")
            # the worker gets COPIES of the node/pod objects: the next loop
            # re-reads and re-encodes the live ones concurrently (a shared
            # object would race); failed-node rollback is deferred to drain_completed()
            # on the control-loop thread, against the live Node
            work = [replace(r, node=self._copy_node(r.node)) for r in to_remove]
            slots = None
            if pods_by_slot is not None:
                needed = {s for r in to_remove
                          for s in (*r.pods_to_move, *r.ds_to_evict)}
                slots = {s: copy.copy(pods_by_slot[s])
                         for s in needed if s in pods_by_slot}

            def run():
                # results land in this shared list AS THEY COMPLETE inside
                # _execute_deletion, so nodes that finished before an
                # unexpected exception still reach _completed — their
                # bookkeeping fires and their _live_nodes entries are
                # reclaimed instead of leaking
                results: list[DeletionResult] = []
                try:
                    self._execute_deletion(
                        work, slots, now, force, pre_tainted=True,
                        defer_rollback=True, out_results=results)
                except Exception as e:  # noqa: BLE001 — a worker must never
                    # strand its nodes: synthesize terminal failures so
                    # drain_completed still rolls back and books them
                    for r in work:
                        # whoever is still in flight got no terminal result
                        if not self.tracker.is_deleting(r.node.name):
                            continue
                        self.tracker.finish(r.node.name, False, repr(e))
                        results.append(
                            DeletionResult(r.node.name, False, repr(e)))
                with self._completed_lock:
                    self._completed.extend(results)
                if self.on_result is not None:
                    for res in results:
                        self.on_result(res)

            self._bg.submit(run)
            return []
        return self._execute_deletion(to_remove, pods_by_slot, now, force)

    @staticmethod
    def _copy_node(node: Node) -> Node:
        nd = copy.copy(node)
        nd.taints = list(node.taints)
        return nd

    def drain_completed(self) -> list[DeletionResult]:
        """Pop finished DETACHED deletions; called at the top of RunOnce so
        registry/observer/metric bookkeeping — and failed-node rollback —
        happen on the control-loop thread (reference: deletion results are
        consumed via NodeDeletionTracker.DeletionResults in RunOnce, not in
        the deletion goroutines)."""
        with self._completed_lock:
            done, self._completed = self._completed, []
        for res in done:
            live = self._live_nodes.pop(res.node, None)
            if live is not None and not res.ok:
                self._rollback_node(live)
        return done

    def _execute_deletion(
        self,
        to_remove: list[NodeToRemove],
        pods_by_slot: dict[int, Pod] | None,
        now: float,
        force: bool,
        pre_tainted: bool = False,
        defer_rollback: bool = False,
        out_results: list[DeletionResult] | None = None,
    ) -> list[DeletionResult]:
        """`out_results`, when given, receives each DeletionResult AS IT
        COMPLETES (appends are atomic under the GIL) — the detached worker
        passes a shared list so partially-finished work survives an
        unexpected crash of the remainder."""
        empty = [r for r in to_remove if r.is_empty]
        drain = [r for r in to_remove if not r.is_empty]

        if not pre_tainted:
            for r in to_remove:
                if self.options.cordon_node_before_terminating:
                    # reference: --cordon-node-before-terminating marks the
                    # node unschedulable before the taint lands
                    r.node.unschedulable = True
                self.taint_to_be_deleted(r.node)
                self.tracker.start(r.node.name, now, drain=not r.is_empty)

        def evict_daemonsets(r: NodeToRemove) -> None:
            """--daemonset-eviction-for-{empty,occupied}-nodes."""
            enabled = (self.options.daemonset_eviction_for_empty_nodes
                       if r.is_empty
                       else self.options.daemonset_eviction_for_occupied_nodes)
            if not enabled or not self.eviction_sink or not pods_by_slot:
                return
            for s in r.ds_to_evict:
                pod = pods_by_slot.get(s)
                if pod is not None:
                    try:  # DS eviction is best-effort (drain.go:106)
                        self._evict_once(pod, r.node, self._grace_for(pod))
                    except Exception:  # noqa: BLE001
                        pass

        results: list[DeletionResult] = \
            out_results if out_results is not None else []
        # empty nodes: batched per group (reference: delete_in_batch.go)
        by_group: dict[str, list[NodeToRemove]] = {}
        for r in empty:
            g = self.provider.node_group_for_node(r.node)
            if g is None:
                self.tracker.finish(r.node.name, False, "NoNodeGroup")
                # a terminal result for every started node — the detached
                # path's deferred bookkeeping/rollback depends on it
                results.append(DeletionResult(r.node.name, False, "NoNodeGroup"))
                continue
            by_group.setdefault(g.id(), []).append(r)
        for gid, rs in by_group.items():
            g = next(x for x in self.provider.node_groups() if x.id() == gid)
            # chunked so one cloud call never exceeds the bulk limit, but every
            # tainted node gets a terminal result (no tainted zombies)
            step = max(self.options.max_empty_bulk_delete, 1)
            for start in range(0, len(rs), step):
                batch = rs[start:start + step]
                try:
                    for r in batch:
                        evict_daemonsets(r)
                    if force:
                        g.force_delete_nodes([r.node for r in batch])
                    else:
                        g.delete_nodes([r.node for r in batch])
                    for r in batch:
                        # append in the same breath as finish: once the
                        # tracker says "not deleting", the detached crash
                        # handler will NOT synthesize a result, so anything
                        # raised between the two (latency observer, a later
                        # batch member) must not lose this one
                        self.tracker.finish(r.node.name, True)
                        results.append(DeletionResult(r.node.name, True))
                        if self.latency_tracker is not None:
                            self.latency_tracker.observe_deletion(r.node.name, now)
                except NodeGroupError as e:
                    for r in batch:
                        if not defer_rollback:
                            self._rollback_node(r.node)
                        self.tracker.finish(r.node.name, False, str(e))
                        results.append(DeletionResult(r.node.name, False, str(e)))

        # drain nodes: parallel per node under the drain budget; each
        # worker appends its result in the same breath as tracker.finish —
        # an exception AFTER finish (latency observer) must not strand a
        # node the crash handler no longer sees as in flight
        def drain_one(r: NodeToRemove) -> DeletionResult:
            try:
                if self.eviction_sink and pods_by_slot:
                    victims = [pods_by_slot[s] for s in r.pods_to_move
                               if s in pods_by_slot]
                    if self.pdb_tracker is not None and not force:
                        # last-moment atomic PDB gate (reference: drain.go
                        # re-checks budgets at eviction time, not just plan
                        # time); atomic because drains run in worker threads.
                        # Forced deletion bypasses PDBs (StartForceDeletion).
                        if not self.pdb_tracker.try_remove_pods(victims):
                            raise NodeGroupError("PDB budget exhausted")
                    # per-NODE retry window shared by every pod eviction of
                    # the node (reference: drain.go:185 — retryUntil is
                    # computed once per node and all pod-eviction goroutines
                    # run against it). This also bounds the worst-case stall
                    # of a synchronous drain at max-pod-eviction-time per
                    # NODE, not per pod: a persistently failing
                    # sink costs one window, later pods fail fast and the
                    # drain rolls back to retry next loop.
                    retry_until = self.clock() + \
                        self.options.max_pod_eviction_time_s
                    for pod in priority_eviction_order(victims):
                        self._evict_with_retry(pod, r.node, retry_until,
                                               force=force)
                        # planner anticipation feed (reference:
                        # RegisterEviction per evicted pod, drain.go).
                        # Stamped at EVICTION time — detached drains may run
                        # long after dispatch `now` — in the walltime domain
                        # the control loop prunes with
                        self.tracker.register_eviction(pod, self.walltime())
                    self._wait_pods_gone(r.node, victims)
                    from kubernetes_autoscaler_tpu_torch.metrics.metrics import (
                        default_registry,
                    )

                    default_registry.counter("evicted_pods_total").inc(len(victims))
                evict_daemonsets(r)
                g = self.provider.node_group_for_node(r.node)
                if g is None:
                    raise NodeGroupError("no node group")
                if force:
                    g.force_delete_nodes([r.node])
                else:
                    g.delete_nodes([r.node])
                self.tracker.finish(r.node.name, True)
                res = DeletionResult(r.node.name, True)
                results.append(res)
                if self.latency_tracker is not None:
                    self.latency_tracker.observe_deletion(r.node.name, now)
                return res
            except NodeGroupError as e:
                if not defer_rollback:
                    self._rollback_node(r.node)
                self.tracker.finish(r.node.name, False, str(e))
                res = DeletionResult(r.node.name, False, str(e))
                results.append(res)
                return res

        workers = max(self.options.max_drain_parallelism, 1)
        if drain:
            with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
                list(ex.map(drain_one, drain))  # results append as they land
        return results

"""Scale-up orchestrator: from pending pods to node-group increases.

Reference counterpart: core/scaleup/orchestrator/orchestrator.go —
`ScaleUp` (:88-203): build equivalence groups, filter valid node groups,
compute an expansion option per group via the estimator (:379-414), pick via
the expander (:~1090), balance similar groups (:652), cap by quotas
(:205-217), then execute increases in parallel (executor.go:63-143).

TPU re-design: option computation for ALL node groups happens in one device
program (ops/binpack.estimate_all) instead of a serial per-group loop; the
expander's numeric scores ride the same kernel (ops/scoring). The host layer
here is pure policy: validity filtering, quota caps, winner verification
(exact string semantics for lossily-encoded pods), and cloud actuation.
"""

from __future__ import annotations

import concurrent.futures
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from kubernetes_autoscaler_tpu_torch.cloudprovider.provider import (
    CloudProvider,
    NodeGroup,
    NodeGroupError,
)
from kubernetes_autoscaler_tpu_torch.clusterstate.registry import (
    ClusterStateRegistry,
    _ng_defaults,
)
from kubernetes_autoscaler_tpu_torch.config.options import AutoscalingOptions
from kubernetes_autoscaler_tpu_torch.estimator.estimator import (
    BinpackingEstimator,
    ClusterCapacityThresholdLimiter,
    SngCapacityThresholdLimiter,
    StaticThresholdLimiter,
)
from kubernetes_autoscaler_tpu_torch.expander.strategies import (
    ChainStrategy,
    Option,
    options_from_scores,
)
from kubernetes_autoscaler_tpu_torch.models.encode import (
    EncodedCluster,
    encode_node_groups,
)
from kubernetes_autoscaler_tpu_torch.ops import scoring
from kubernetes_autoscaler_tpu_torch.ops.hostfetch import to_host
from kubernetes_autoscaler_tpu_torch.resourcequotas.tracker import QuotaTracker


@dataclass
class ScaleUpResult:
    scaled_up: bool
    increases: dict[str, int] = field(default_factory=dict)
    errors: dict[str, str] = field(default_factory=dict)
    pods_helped: int = 0
    pods_remaining: int = 0
    considered_options: list[Option] = field(default_factory=list)
    best: Option | None = None


@dataclass
class ScaleUpPrep:
    """Host-side scale-up inputs assembled BEFORE the fused dispatch
    (docs/FUSED_LOOP.md): the valid-group list, the marshalled group
    tensors, and the limiter cap vector the fused program applies on
    device. `limit_cap` is `combined_limit_vec` composed on the host with
    numpy — all three built-in limiters are pure integer functions of the
    cluster size and each group's max_new, both of which the host already
    knows — so the fused program needs no limiter objects inside the trace
    and the cap doubles as a stable speculation-key component."""

    groups: list
    upcoming_only: bool
    templates: list
    group_tensors: object        # NodeGroupTensors (device)
    estimator: BinpackingEstimator
    gpu_slot: int | None
    limit_cap: np.ndarray        # i32[NG] host copy
    limit_cap_dev: object        # i32[NG] device upload (jit input)


@dataclass
class FusedScaleUp:
    """Precomputed scale-up decision inputs harvested from a FusedDecision:
    host numpy est rows + scores. `ScaleUpOrchestrator.scale_up` consumes
    these instead of dispatching its estimate/score program — the rest of
    the policy path (options, expander, balancing, quota, execution,
    refusal reasons) is byte-for-byte the phased code."""

    prep: ScaleUpPrep
    est: object                  # .node_count i32[NG], .scheduled i32[NG, G]
    scores: object               # OptionScores with host numpy leaves
    pending_total: int = 0       # post-filter pending pods (decision tensor)


class ScaleUpOrchestrator:
    def __init__(
        self,
        provider: CloudProvider,
        options: AutoscalingOptions,
        cluster_state: ClusterStateRegistry,
        expander: ChainStrategy,
        quota: QuotaTracker | None = None,
        node_group_list_processor=None,
        node_group_manager=None,
        async_creator=None,
        device=None,
    ):
        from kubernetes_autoscaler_tpu_torch.processors.nodegroups import (
            IdentityNodeGroupListProcessor,
            NodeGroupManager,
        )

        from kubernetes_autoscaler_tpu_torch.metrics.phases import PhaseStats

        from kubernetes_autoscaler_tpu_torch.device import resolve_device

        # every tensor this orchestrator makes (group tensors, the limiter
        # cap, masked counts) lives here
        self.device = resolve_device(device)
        self.provider = provider
        self.options = options
        self.cluster_state = cluster_state
        self.expander = expander
        self.quota = quota
        # per-phase wall-clock breakdown of the scale-up host path, the
        # mirror of Planner.phases on the scale-down side: encode (template
        # tensors), dispatch (estimate + scoring programs), fetch (score
        # readback), confirm (lossy-winner oracle verification)
        self.phases = PhaseStats(owner="scaleup")
        # optional device mesh threaded into the estimator (NG options over
        # PODS_AXIS; parallel/mesh.py) — None = single-device program
        self.mesh = None
        # reason plane (events.EventSink wired by StaticAutoscaler): per-loop
        # NoScaleUp verdicts — {reason: pod count} for the gauge family and
        # the per-group detail list for status/snapshotz. Populated by the
        # LAZY reason pass (_explain_refused): one masked dispatch over the
        # refused groups only, zero dispatches when everything schedules.
        self.event_sink = None
        self.last_noscaleup: dict[str, int] = {}
        self.last_noscaleup_groups: list[dict] = []
        # shadow-audit gate (audit/shadow.py, wired by StaticAutoscaler):
        # while a persistent audit divergence is unhealed, every scale-up
        # option is derived from a verdict plane the audit proved corrupt —
        # options are REFUSED with the AuditDivergence reason instead of
        # actuated (the scale-down analog is the supervisor's safe-action
        # gating). None = no auditor.
        self.audit_gate = None
        self.node_group_list_processor = (
            node_group_list_processor or IdentityNodeGroupListProcessor()
        )
        self.node_group_manager = node_group_manager or NodeGroupManager()
        # AsyncNodeGroupCreator when --async-node-group-creation is on
        # (reference: CreateNodeGroupAsync orchestrator.go:453)
        self.async_creator = async_creator
        # template-tensor cache: the static planes (cap/labels/taints/zone)
        # change only when templates change; max_new/price change every
        # accepted scale-up and are refreshed as two small arrays instead of
        # re-encoding + re-uploading the whole NodeGroupTensors per loop
        self._group_tensor_cache: tuple | None = None
        # last group-tensor fingerprint, exported as a value-based
        # speculation-key component (docs/FUSED_LOOP.md)
        self._last_group_fp: tuple | None = None
        # composition-fingerprint memos (utils/canonical.IdentityMemo): the
        # template-tensor cache key used to re-walk every template's labels/
        # taints/capacity and every DaemonSet's spec each loop; per-object
        # identity memoization makes the key O(churn) under the repo-wide
        # replace-on-update contract (the WorldStore discipline extended to
        # this encode-path cache — docs/WORLD_STORE.md)
        from kubernetes_autoscaler_tpu_torch.utils.canonical import IdentityMemo

        self._template_sig_memo = IdentityMemo(self._template_sig)
        self._workload_sig_memo = IdentityMemo(self._workload_sig)
        # DaemonSet workloads for template DS-overhead charging (set per
        # loop by StaticAutoscaler; reference: node_info_utils.go:45 threads
        # the daemonset lister into every sanitized template)
        self.daemonsets: list = []

    # ---- node-group validity (reference: filterValidScaleUpNodeGroups :152) ----

    def _valid_groups(self, now: float) -> list[NodeGroup]:
        valid = []
        for g in self.provider.node_groups():
            if not g.exist():
                continue
            if g.target_size() >= g.max_size():
                continue
            if not self.cluster_state.is_node_group_safe_to_scale_up(g, now):
                continue
            valid.append(g)
        return valid

    # ---- the main entry (reference: ScaleUp :88) ----

    def _candidate_groups(self, enc: EncodedCluster,
                          now: float) -> tuple[list[NodeGroup], bool]:
        groups = self._valid_groups(now)
        # candidate extension (reference: NodeGroupListProcessor — the
        # autoprovisioning variant appends not-yet-existing groups)
        groups = self.node_group_list_processor.process(
            self.provider, groups, enc.pending_pods
        )
        upcoming_only = False
        if self.async_creator is not None:
            # a group whose creation is still in flight must not be
            # re-proposed (reference: AsyncNodeGroupStateChecker gating)
            before = groups
            groups = [g for g in before
                      if not self.async_creator.is_upcoming(g.id())]
            upcoming_only = bool(before) and not groups
        return groups, upcoming_only

    def _build_estimator(self, enc: EncodedCluster) -> BinpackingEstimator:
        return BinpackingEstimator(
            enc.dims,
            max_new_nodes_static=self.options.max_new_nodes_static,
            limiters=[
                StaticThresholdLimiter(self.options.max_nodes_per_scaleup),
                ClusterCapacityThresholdLimiter(self.options.max_nodes_total),
                SngCapacityThresholdLimiter(),
            ],
            planes=enc.planes,
            nodes=enc.nodes,
            with_constraints=enc.has_constraints,
            mesh=self.mesh,
        )

    def _templates_for(self, groups: list[NodeGroup]) -> list:
        templates = []
        for g in groups:
            tmpl = g.template_node_info()
            if self.options.scale_from_unschedulable and tmpl.unschedulable:
                # reference: --scale-from-unschedulable ignores
                # .spec.unschedulable in node templates
                tmpl.unschedulable = False
            templates.append((tmpl, g.max_size() - g.target_size(),
                              getattr(g, "price_per_node", 1.0)))
        return templates

    def prepare_fused(self, enc: EncodedCluster, nodes_count: int,
                      now: float) -> ScaleUpPrep | None:
        """Assemble the scale-up half of the fused program's inputs before
        dispatch. Returns None when no candidate node group exists (the
        fused loop then runs phased — there are no group tensors to trace
        over). The host-composed `limit_cap` replicates
        `combined_limit_vec` over the three built-in limiters exactly;
        tests/test_fused_loop.py pins the equivalence."""
        groups, upcoming_only = self._candidate_groups(enc, now)
        if not groups:
            return None
        estimator = self._build_estimator(enc)
        templates = self._templates_for(groups)
        with self.phases.phase("encode", groups=len(groups)):
            group_tensors = self._group_tensors(templates, enc)
        max_new = np.zeros((int(group_tensors.ng),), np.int32)
        for i, (_tmpl, mx, _pr) in enumerate(templates):
            max_new[i] = mx
        cap = np.full_like(max_new, np.int32(1 << 30))
        cap = np.minimum(cap, np.int32(self.options.max_nodes_per_scaleup))
        if self.options.max_nodes_total > 0:
            cap = np.minimum(cap, np.int32(
                max(self.options.max_nodes_total - nodes_count, 0)))
        cap = np.minimum(cap, np.maximum(max_new, 0))
        gpu_slot = enc.registry.slots.get(self.provider.gpu_resource_name())
        # cache the device upload on the cap BYTES: steady loops reuse the
        # same buffer (zero h2d), and a byte change is a speculation-key miss
        cached = getattr(self, "_limit_cap_cache", None)
        if cached is not None and np.array_equal(cached[0], cap):
            cap_dev = cached[1]
        else:
            cap_dev = torch.from_numpy(cap.copy()).to(self.device)
            self._limit_cap_cache = (cap, cap_dev)
        return ScaleUpPrep(groups=groups, upcoming_only=upcoming_only,
                           templates=templates, group_tensors=group_tensors,
                           estimator=estimator, gpu_slot=gpu_slot,
                           limit_cap=cap, limit_cap_dev=cap_dev)

    def scale_up(self, enc: EncodedCluster, nodes_count: int,
                 now: float | None = None,
                 precomputed: FusedScaleUp | None = None) -> ScaleUpResult:
        now = time.time() if now is None else now
        self.last_noscaleup = {}
        self.last_noscaleup_groups = []
        if precomputed is not None:
            # the fused decision tensors carry the post-filter pending count;
            # reading enc.specs.count here would force a device sync
            pending_total = int(precomputed.pending_total)
        else:
            pending_total = int(to_host(enc.specs.count).sum())
        if pending_total == 0:
            return ScaleUpResult(scaled_up=False)

        if self.audit_gate is not None and self.audit_gate():
            # persistent shadow-audit divergence: refuse rather than scale
            # on corrupt verdict bits. Every pending group gets the
            # AuditDivergence verdict on all four reason surfaces (event /
            # status / unschedulable_pods_count{reason} / snapshotz) — no
            # device dispatch, the plane is exactly what is not trusted.
            self._refuse_all_pending(enc, "AuditDivergence", now)
            return ScaleUpResult(scaled_up=False,
                                 pods_remaining=pending_total)

        if precomputed is not None:
            groups = precomputed.prep.groups
            upcoming_only = precomputed.prep.upcoming_only
        else:
            groups, upcoming_only = self._candidate_groups(enc, now)
        if not groups:
            # no candidate group exists — every pending group gets the
            # summary reason without any device dispatch. If candidates
            # exist but are all still being created, "no node group can
            # help" would be false — capacity for these pods is in flight —
            # so no refusal verdict is recorded.
            if not upcoming_only:
                self._note_no_groups(enc, now)
            return ScaleUpResult(scaled_up=False, pods_remaining=pending_total)

        if precomputed is not None:
            # fused path: est/scores were computed INSIDE the fused program
            # and harvested with the loop's single decision fetch — no
            # dispatch here. The estimator still re-estimates for lossy
            # winner verification; point it at the post-placement world the
            # phased estimator would have been built from.
            estimator = precomputed.prep.estimator
            estimator.planes = enc.planes
            estimator.nodes = enc.nodes
            group_tensors = precomputed.prep.group_tensors
            gpu_slot = precomputed.prep.gpu_slot
            est = precomputed.est
            scores = precomputed.scores
        else:
            estimator = self._build_estimator(enc)
            templates = self._templates_for(groups)
            with self.phases.phase("encode", groups=len(groups)):
                group_tensors = self._group_tensors(templates, enc)
            with self.phases.phase("dispatch", groups=len(groups),
                                   pending=pending_total):
                est = estimator.estimate_all_groups(enc.specs, group_tensors,
                                                    nodes_count)
                scores = scoring.score_options(est, group_tensors,
                                               specs=enc.specs)
            # non-allocating lookup: try_slot_for would BURN one of the four
            # extended slots for the GPU name even on GPU-less clusters (any
            # GPU-bearing template/node already allocated it at encode time)
            gpu_slot = enc.registry.slots.get(self.provider.gpu_resource_name())
        with self.phases.phase("fetch"):
            options = options_from_scores(scores, [g.id() for g in groups],
                                          groups=groups, gpu_slot=gpu_slot,
                                          phases=self.phases)
        with self.phases.phase("confirm"):
            options = self._verify_lossy_winners(
                options, est, enc, groups, estimator, group_tensors,
                nodes_count
            )
        if not options:
            self._explain_refused(enc, est, group_tensors, now)
            return ScaleUpResult(scaled_up=False, pods_remaining=pending_total,
                                 considered_options=[])

        # per-loop context for filters that need it (price expander's
        # preferred-node heuristic scales with cluster size)
        for f in self.expander.filters:
            set_ctx = getattr(f, "set_loop_context", None)
            if set_ctx is not None:
                set_ctx(nodes_count)
        best = self.expander.best_option(options)
        if best is None:
            self._explain_refused(enc, est, group_tensors, now)
            return ScaleUpResult(scaled_up=False, pods_remaining=pending_total,
                                 considered_options=options)

        # ZeroOrMaxNodeScaling winners scale all-or-nothing and are excluded
        # from similar-group balancing — balancing several atomic groups
        # would blow each to max (reference: atomic groups bypass the
        # BalancingNodeGroupSetProcessor and use AtomicIncreaseSize).
        winner = groups[best.group_index]
        if self._ng_opts(winner).zero_or_max_node_scaling:
            plan = {winner.id(): winner.max_size() - winner.target_size()}
        else:
            # similar-group balancing (reference: balanceScaleUps :652 via
            # BalancingNodeGroupSetProcessor) — split the winning delta
            # across groups similar to the winner.
            plan = self._balance(best, groups, est, enc)

        # quota caps (reference: applyLimits :205-217)
        plan = self._apply_quota(plan, groups, enc)
        if not plan:
            return ScaleUpResult(scaled_up=False, pods_remaining=pending_total,
                                 considered_options=options, best=best)

        result = self._execute(plan, groups, now)
        result.considered_options = options
        result.best = best
        result.pods_helped = best.pod_count
        result.pods_remaining = max(pending_total - best.pod_count, 0)
        if result.pods_remaining > 0:
            # pods are left behind even after the winning option — attribute
            # them (groups no template could host; the lazy reason pass)
            self._explain_refused(enc, est, group_tensors, now)
        return result

    # ---- the reason plane (lazy NoScaleUp extraction) ----

    def _note_no_groups(self, enc: EncodedCluster, now: float) -> None:
        """Every pending pod group is refused because no valid node group
        exists at all — the summary reason needs no device dispatch."""
        from kubernetes_autoscaler_tpu_torch.ops.predicates import NO_NODE_IN_GROUP

        self._refuse_all_pending(enc, NO_NODE_IN_GROUP, now)

    def _refuse_all_pending(self, enc: EncodedCluster, reason: str,
                            now: float) -> None:
        """One whole-loop refusal verdict (`reason`) for every valid
        pending group, onto all the orchestrator-owned surfaces."""
        counts = to_host(enc.specs.count)
        valid = to_host(enc.specs.valid)
        for gi in np.nonzero(valid & (counts > 0))[0]:
            self._record_noscaleup(enc, int(gi), int(counts[gi]),
                                   reason, {}, now)

    def _explain_refused(self, enc: EncodedCluster, est, group_tensors,
                         now: float) -> None:
        """Lazy reason extraction for refused pod groups: one masked
        `reason_mask_for_groups` dispatch over the TEMPLATE plane (uint16
        bits per group × node group) + one batched fetch, only when at least
        one pending group no expansion option could schedule. A loop where
        every pod is helped performs ZERO extra dispatches — the
        `reason_extraction_dispatches` event counter (mirrored into
        `phase_events_total` and the trace) proves it, and CI asserts it on
        the all-schedulable bench smoke world."""
        from kubernetes_autoscaler_tpu_torch.estimator.estimator import (
            explain_refused_groups,
        )
        from kubernetes_autoscaler_tpu_torch.ops import predicates as preds

        counts = to_host(enc.specs.count)
        valid = to_host(enc.specs.valid)
        scheduled = to_host(est.scheduled)          # [NG, G]
        helped = (scheduled.max(axis=0) if scheduled.size
                  else np.zeros_like(counts))
        refused = valid & (counts > 0) & (helped <= 0)
        if not refused.any():
            return
        with self.phases.phase("reason_extract",
                               refused_groups=int(refused.sum())):
            self.phases.bump("reason_extraction_dispatches")
            bits = explain_refused_groups(enc.specs, group_tensors, refused,
                                          enc.dims)
        gvalid = to_host(group_tensors.valid)
        for gi in np.nonzero(refused)[0]:
            headline, per = preds.summarize_reason_row(bits[gi], gvalid)
            self._record_noscaleup(enc, int(gi), int(counts[gi]), headline,
                                   per, now)

    def _record_noscaleup(self, enc: EncodedCluster, gi: int, pods: int,
                          reason: str, constraints: dict[str, int],
                          now: float) -> None:
        """One refused group's verdict onto every surface the orchestrator
        owns: the per-reason totals (→ unschedulable_pods_count{reason}),
        the per-group detail list (→ status document + /snapshotz), and a
        deduped NoScaleUp event keyed by the group's exemplar pod (the
        reference emits the same verdict per pod; equivalence rows make one
        event per shape)."""
        exemplar = ""
        if gi < len(enc.group_pods) and enc.group_pods[gi]:
            exemplar = enc.pending_pods[enc.group_pods[gi][0]].name
        obj = exemplar or f"pod-group-{gi}"
        self.last_noscaleup[reason] = self.last_noscaleup.get(reason, 0) + pods
        self.last_noscaleup_groups.append({
            "group": gi, "exemplarPod": obj, "pods": pods,
            "reason": reason, "constraints": constraints,
        })
        if self.event_sink is not None:
            from kubernetes_autoscaler_tpu_torch.ops.predicates import (
                CAPPED_BY_LIMITS,
                NO_NODE_IN_GROUP,
            )

            detail = ", ".join(f"{k}×{v}" for k, v in constraints.items())
            if reason == CAPPED_BY_LIMITS:
                # the opposite of a constraint refusal: a template CAN host
                # the group, the option was capped/crowded out
                msg = (f"{pods} pending pods fit a node group template, but "
                       f"option capping (max_new / limiter stack / crowded "
                       f"bins) left them behind")
            elif reason == NO_NODE_IN_GROUP:
                msg = f"{pods} pending pods; no candidate node group exists"
            elif reason == "AuditDivergence":
                msg = (f"{pods} pending pods; scale-up refused — the "
                       f"shadow audit proved the device verdict plane "
                       f"diverges from the host oracle and the divergence "
                       f"survived a forced re-encode (docs/OBSERVABILITY"
                       f".md \"Shadow audit\")")
            else:
                msg = (f"{pods} pending pods; no node group can host them"
                       + (f" (refusing templates: {detail})" if detail
                          else ""))
            self.event_sink.emit("NoScaleUp", obj=obj, reason=reason,
                                 message=msg, now=now)

    # ---- winner verification (the host-check tier) ----

    def _verify_lossy_winners(self, options, est, enc: EncodedCluster, groups,
                              estimator, group_tensors, nodes_count: int):
        """Exact-check lossily-encoded pod groups against each option's
        template. Options relying on refuted pods are RE-ESTIMATED with those
        pods masked out so node_count/waste/price reflect only pods that will
        actually schedule. Plays the role of the reference's real scheduler
        framework run — predicate truth always comes from exact semantics
        before actuation. The oracle sees the FULL cluster (nodes + resident
        pods), so topology spread / inter-pod affinity / multi-term node
        affinity are all evaluated exactly (check_pod_on_new_node).

        Re-estimation is BATCHED: all oracle checks run first, then options
        sharing a refuted-pod mask share one estimate_all dispatch (refuted
        sets are template-determined, so similar templates coalesce) — the
        device round trips scale with distinct masks, not flagged options."""
        flagged = to_host(enc.specs.needs_host_check)
        if not flagged.any():
            return options
        all_nodes, pods_by_node = enc.all_nodes_and_pods()
        # incremental constraint cache: the full oracle walks nodes x pods
        # PER exemplar check — seconds per flagged option at 5k x 50k
        from kubernetes_autoscaler_tpu_torch.utils.oracle_cache import ConfirmOracle

        oracle_world = ConfirmOracle(all_nodes, pods_by_node,
                                     registry=enc.registry,
                                     namespaces=enc.namespaces)
        scheduled = to_host(est.scheduled)  # [NG, G]
        # --max-binpacking-time bounds the whole option computation; once the
        # budget is gone, options needing a re-estimate are dropped rather
        # than shipped unverified (reference: BinpackingLimiter stops
        # computing further options)
        deadline = time.monotonic() + self.options.max_binpacking_time_s
        gpu_slot = enc.registry.slots.get(self.provider.gpu_resource_name())
        from kubernetes_autoscaler_tpu_torch.utils.daemonset import (
            daemonset_pods_for_node,
        )

        # pass 1: oracle-check every option, bucketing by refuted-pod mask
        resolved: dict[int, Option | None] = {}
        by_mask: dict[tuple, list[Option]] = {}
        for opt in options:
            g_t = groups[opt.group_index].template_node_info()
            # the exact tier sees the same DS-loaded fresh node the dense
            # capacity rows encode (node_info_utils.go:45)
            ds_pods = daemonset_pods_for_node(g_t, self.daemonsets) \
                if self.daemonsets else None
            refuted: list[int] = []
            for gi in np.nonzero(flagged)[0]:
                if scheduled[opt.group_index, gi] <= 0:
                    continue
                if gi < len(enc.group_pods) and enc.group_pods[gi]:
                    exemplar = enc.pending_pods[enc.group_pods[gi][0]]
                    if not oracle_world.check_on_new_node(
                            exemplar, g_t, resident_pods=ds_pods):
                        refuted.append(int(gi))
            if not refuted:
                resolved[id(opt)] = opt
            else:
                by_mask.setdefault(tuple(sorted(refuted)), []).append(opt)
                self.phases.bump("lossy_reestimate_options")

        # pass 2: one re-estimate per DISTINCT refuted mask, consumed by
        # every surviving option that shares it
        from kubernetes_autoscaler_tpu_torch.models.resources import CPU, MEMORY

        for refuted, opts_b in by_mask.items():
            if time.monotonic() > deadline:
                continue  # budget exhausted: unverifiable options are dropped
            self.phases.bump("lossy_reestimate_dispatches")
            count = to_host(enc.specs.count).copy()
            count[list(refuted)] = 0
            masked = enc.specs.replace(
                count=torch.from_numpy(count).to(self.device))
            redo = estimator.estimate_all_groups(masked, group_tensors,
                                                 nodes_count)
            sc = scoring.fetch_scores(
                scoring.score_options(redo, group_tensors, specs=masked))
            helped = to_host(sc.helped_req)
            for opt in opts_b:
                i = opt.group_index
                if not bool(sc.valid[i]):
                    continue
                resolved[id(opt)] = Option(
                    group_index=i, group_id=opt.group_id,
                    node_count=int(sc.nodes[i]), pod_count=int(sc.pods[i]),
                    waste=float(sc.waste[i]), price=float(sc.price[i]),
                    template=opt.template, exists=opt.exists,
                    helped_cpu_milli=float(helped[i, CPU]),
                    helped_mem_mib=float(helped[i, MEMORY]),
                    # from the re-estimate, like cpu/mem — the pre-mask value
                    # would overstate GPU help for options with refuted pods
                    helped_gpus=(float(helped[i, gpu_slot])
                                 if gpu_slot is not None else 0.0),
                )
        # original option order preserved (expander tie-breaks see the same
        # sequence the serial path produced)
        return [resolved[id(o)] for o in options
                if resolved.get(id(o)) is not None]

    @staticmethod
    def _template_sig(tmpl) -> tuple:
        """Content signature of one template node for the group-tensor cache
        key (memoized by object identity via IdentityMemo — providers that
        return a cached template object pay O(1) per loop; providers that
        mint a fresh Node per call recompute, exactly the old behavior)."""
        return (tmpl.name, tuple(sorted(tmpl.labels.items())),
                tuple((t.key, t.value, t.effect) for t in tmpl.taints),
                tuple(sorted((k, float(v))
                             for k, v in tmpl.alloc_or_cap().items())))

    @staticmethod
    def _workload_sig(w) -> tuple:
        """DS churn changes the charged capacity rows — every field
        daemonset_overhead consults: requests + overhead (the charge),
        selector/affinity/tolerations (the node match)."""
        return (w.namespace, w.name, w.uid,
                (tuple(sorted((k, float(v))
                              for k, v in w.template.requests.items())),
                 tuple(sorted((k, float(v))
                              for k, v in w.template.overhead.items())),
                 tuple(sorted(w.template.node_selector.items())),
                 tuple(tuple((r.key, r.operator, r.values) for r in term)
                       for term in w.template.affinity_node_terms()),
                 tuple((t.key, t.value, t.effect, t.operator)
                       for t in w.template.tolerations))
                if w.template is not None else None)

    def _group_tensors(self, templates, enc):
        """encode_node_groups with the static planes cached across loops."""
        from kubernetes_autoscaler_tpu_torch.models.cluster_state import pad_to

        fp = (
            tuple(self._template_sig_memo.refresh(
                [tmpl for tmpl, _mx, _pr in templates])),
            # the full MAPPINGS, not their sizes: a rebuild can reassign
            # the same number of slot/zone ids in a different first-seen
            # order
            tuple(sorted(enc.registry.slots.items())),
            tuple(sorted(enc.zone_table.ids.items())),
            enc.dims,
            tuple(self._workload_sig_memo.refresh(self.daemonsets)),
        )
        # value-based fingerprint for the speculation key: the cache-hit
        # path below rebuilds max_new/price arrays every loop, so object
        # identity on the tensors never holds across loops
        self._last_group_fp = fp
        cached = self._group_tensor_cache
        if cached is not None and cached[0] == fp:
            gt = cached[1]
            ng_pad = pad_to(max(len(templates), 1), 8)
            if gt.ng == ng_pad:
                self.phases.bump("group_tensor_cache_hit")
                max_new = np.zeros((ng_pad,), np.int32)
                price = np.zeros((ng_pad,), np.float32)
                for i, (_tmpl, mx, pr) in enumerate(templates):
                    max_new[i] = mx
                    price[i] = pr
                gt = gt.replace(
                    max_new=torch.from_numpy(max_new).to(self.device),
                    price_per_node=torch.from_numpy(price).to(self.device))
                self._group_tensor_cache = (fp, gt)
                return gt
        # a miss re-encodes + re-uploads the whole NodeGroupTensors — a
        # recompile-risk event on the trace (new tensor identities feed the
        # estimator's jit)
        self.phases.bump("group_tensor_cache_miss")
        gt = encode_node_groups(templates, enc.registry, enc.zone_table,
                                enc.dims, daemonsets=self.daemonsets,
                                device=self.device)
        self._group_tensor_cache = (fp, gt)
        # HBM residency ledger (metrics/device.py): the marshalled group
        # tensors are device arrays held across loops by this cache
        from kubernetes_autoscaler_tpu_torch.metrics import device

        if device.LEDGER is not None:
            device.LEDGER.track("marshal", "group_tensors", gt)
        return gt

    # ---- similar-group balancing (reference: compare_nodegroups.go:105) ----

    def _balance(self, best: Option, groups: list[NodeGroup], est,
                 enc=None) -> dict[str, int]:
        if not self.options.balance_similar_node_groups:
            return {best.group_id: best.node_count}
        target = groups[best.group_index]
        tmpl = target.template_node_info()
        free = _group_exemplar_free(enc, groups, self.provider) \
            if enc is not None else {}
        similar = [target]
        for i, g in enumerate(groups):
            if g.id() == target.id():
                continue
            if self._ng_opts(g).zero_or_max_node_scaling:
                continue  # an atomic sibling cannot absorb a partial split
            t = g.template_node_info()
            if _similar_templates(tmpl, t, self.options,
                                  free_a=free.get(target.id()),
                                  free_b=free.get(g.id())) \
                    and g.target_size() < g.max_size():
                similar.append(g)
        total = best.node_count
        plan: dict[str, int] = {}
        # even split honoring current target sizes (fill smallest first);
        # groups at max size drop out of the rotation, they don't stop it
        sizes = {g.id(): g.target_size() for g in similar}
        caps = {g.id(): g.max_size() for g in similar}
        for _ in range(total):
            open_groups = {k: v for k, v in sizes.items() if v < caps[k]}
            if not open_groups:
                break
            gid = min(open_groups, key=lambda k: open_groups[k])
            sizes[gid] += 1
            plan[gid] = plan.get(gid, 0) + 1
        return plan or {best.group_id: best.node_count}

    # ---- quota caps ----

    def _ng_opts(self, g: NodeGroup):
        return g.get_options(_ng_defaults(self.options))

    def _apply_quota(self, plan: dict[str, int], groups: list[NodeGroup],
                     enc: EncodedCluster) -> dict[str, int]:
        capped = dict(plan)
        if self.quota is not None:
            status = self.quota.status_from_encoded(enc)
            for gid in list(capped):
                g = next(gr for gr in groups if gr.id() == gid)
                allowed = self.quota.max_nodes_addable(
                    status, g.template_node_info(), capped[gid]
                )
                if allowed < capped[gid]:
                    from kubernetes_autoscaler_tpu_torch.metrics.metrics import (
                        default_registry,
                    )

                    default_registry.counter("skipped_scale_events_count").inc(
                        direction="up", reason="ResourceLimits")
                if allowed < capped[gid] and self._ng_opts(g).zero_or_max_node_scaling:
                    # an atomic group cannot partially scale: all or nothing
                    del capped[gid]
                elif allowed <= 0:
                    del capped[gid]
                elif allowed < capped[gid]:
                    capped[gid] = allowed
        return capped

    # ---- execution (reference: executor.go:96-143, parallel per group) ----

    def _execute(self, plan: dict[str, int], groups: list[NodeGroup],
                 now: float) -> ScaleUpResult:
        by_id = {g.id(): g for g in groups}
        result = ScaleUpResult(scaled_up=False)

        def one(gid: str, delta: int):
            g = by_id[gid]
            if not g.exist():
                if (self.async_creator is not None
                        and self.options.async_node_group_creation):
                    # fire-and-track: creation + initial scale-up happen off
                    # the loop thread; capacity counts as upcoming meanwhile
                    # (reference: CreateNodeGroupAsync + async_initializer.go)
                    self.async_creator.create_async(g, delta, now)
                    return gid, delta, True
                # winner is an auto-provisioning candidate: create first
                # (reference: orchestrator CreateNodeGroup before IncreaseSize)
                self.node_group_manager.create_node_group(g)
            if self._ng_opts(g).zero_or_max_node_scaling:
                g.atomic_increase_size(delta)
            else:
                g.increase_size(delta)
            return gid, delta, False

        workers = 8 if self.options.parallel_scale_up else 1
        with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
            futures = {ex.submit(one, gid, d): gid for gid, d in plan.items()}
            for fut in concurrent.futures.as_completed(futures):
                gid = futures[fut]
                try:
                    _, delta, async_pending = fut.result()
                    result.increases[gid] = delta
                    if not async_pending:
                        # async creations register with the CSR when the
                        # creator's pipeline completes, not here
                        self.cluster_state.register_scale_up(by_id[gid], delta, now)
                    result.scaled_up = True
                except NodeGroupError as e:
                    result.errors[gid] = str(e)
                    self.cluster_state.register_failed_scale_up(by_id[gid], now)
        return result

    # ---- min-size enforcement (reference: ScaleUpToNodeGroupMinSize :223) ----

    def scale_up_to_min_sizes(self, now: float | None = None) -> ScaleUpResult:
        now = time.time() if now is None else now
        result = ScaleUpResult(scaled_up=False)
        for g in self._valid_groups(now):
            delta = g.min_size() - g.target_size()
            if delta > 0:
                try:
                    g.increase_size(delta)
                    self.cluster_state.register_scale_up(g, delta, now)
                    result.increases[g.id()] = delta
                    result.scaled_up = True
                except NodeGroupError as e:
                    result.errors[g.id()] = str(e)
                    self.cluster_state.register_failed_scale_up(g, now)
        return result


def _group_exemplar_free(enc, groups, provider) -> dict[str, "np.ndarray"]:
    """Per-group FREE resource vector from a live exemplar node (reference:
    compare_nodegroups.go:109-121 builds free = allocatable - requested from
    the groups' exemplar NodeInfos). Groups without a registered node have
    no exemplar — free comparison is skipped for them (a template is empty
    by construction, so template-vs-template free degenerates to allocatable,
    which is already compared).

    nodes.group_id holds indices into the FULL provider.node_groups()
    enumeration (static_autoscaler._node_group_index), not into the filtered
    `groups` list — map through the provider ordering."""
    gid_arr = to_host(enc.nodes.group_id)
    valid = to_host(enc.nodes.valid)
    free_all = to_host(enc.nodes.cap) - to_host(enc.nodes.alloc)
    provider_index = {g.id(): i for i, g in enumerate(provider.node_groups())}
    out: dict[str, np.ndarray] = {}
    for g in groups:
        pi = provider_index.get(g.id())
        if pi is None:
            continue
        rows = np.nonzero(valid & (gid_arr == pi))[0]
        if rows.size:
            out[g.id()] = free_all[rows[0]]
    return out


def _similar_templates(a, b, options: AutoscalingOptions | None = None,
                       free_a=None, free_b=None) -> bool:
    """Reference similarity: capacity within --max-allocatable-difference-ratio
    (memory within --memory-difference-ratio), exemplar FREE resources within
    --max-free-difference-ratio, same labels ignoring zone/hostname plus
    --balancing-ignore-label entries; --balancing-label switches to comparing
    ONLY the listed labels
    (processors/nodegroupset/compare_nodegroups.go:100-153 + flags)."""
    IGNORE = {"kubernetes.io/hostname", "topology.kubernetes.io/zone",
              "failure-domain.beta.kubernetes.io/zone"}
    ratio = options.max_allocatable_difference_ratio if options else 0.05
    mem_ratio = options.memory_difference_ratio if options else 0.015
    if options:
        IGNORE = IGNORE | set(options.balancing_ignore_labels)

    def caps(n):
        return {k: float(v) for k, v in n.alloc_or_cap().items()}

    ca, cb = caps(a), caps(b)
    if set(ca) != set(cb):
        return False
    for k in ca:
        hi = max(ca[k], cb[k])
        limit = mem_ratio if k == "memory" else ratio
        if hi > 0 and abs(ca[k] - cb[k]) / hi > limit:
            return False
    if free_a is not None and free_b is not None and options is not None:
        free_ratio = options.max_free_difference_ratio
        for fa, fb in zip(free_a.tolist(), free_b.tolist()):
            hi = max(fa, fb)
            if hi > 0 and abs(fa - fb) / hi > free_ratio:
                return False
    if options and options.balancing_labels:
        keys = options.balancing_labels
        return all(a.labels.get(k) == b.labels.get(k) for k in keys)
    la = {k: v for k, v in a.labels.items() if k not in IGNORE}
    lb = {k: v for k, v in b.labels.items() if k not in IGNORE}
    return la == lb

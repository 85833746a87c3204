"""Processors: the pluggable policy hook points around the control loop.

Reference counterpart: processors/processors.go:38-79 — the
AutoscalingProcessors struct with 18 hooks and defaults at :82+. The hooks
kept here are the ones with behavioral force in the simulation loop; the
event/status observers are callback lists. Host-side pod-list hooks run
before tensor encoding; the filter-out-schedulable step itself is a device
kernel invoked by StaticAutoscaler (it needs the snapshot), mirroring how the
reference's combined pod-list processor consults the ClusterSnapshot
(core/podlistprocessor/filter_out_schedulable.go:103).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Protocol

from kubernetes_autoscaler_tpu_torch.cloudprovider.provider import CloudProvider, NodeGroup
from kubernetes_autoscaler_tpu_torch.config.options import AutoscalingOptions
from kubernetes_autoscaler_tpu_torch.models.api import Node, Pod


class PodListProcessor(Protocol):
    """Mutate the pending-pod list before scale-up (reference:
    NewDefaultPodListProcessor chain, core/podlistprocessor/)."""

    def process(self, pods: list[Pod], ctx: "ProcessorContext") -> list[Pod]: ...


@dataclass
class ProcessorContext:
    options: AutoscalingOptions
    provider: CloudProvider
    now: float = field(default_factory=time.time)
    # workload lister for pod injection (reference: podinjection reads
    # Deployments/Jobs/ReplicaSets via listers); None = feature off
    list_workloads: Callable[[], list] | None = None


class ClearTpuRequestsProcessor:
    """reference: core/podlistprocessor/clear_tpu_request.go — strip GKE TPU
    requests so they don't block simulated scheduling (utils/tpu/tpu.go:17-35).
    Amusingly load-bearing for a TPU-native framework: google.com/tpu requests
    are handled by device plugins, not the scheduler's resource math."""

    TPU_RESOURCE = "google.com/tpu"

    def process(self, pods, ctx):
        for p in pods:
            p.requests.pop(self.TPU_RESOURCE, None)
        return pods


class CurrentlyDrainedNodesProcessor:
    """reference: core/podlistprocessor/currently_drained_nodes.go — pods on
    nodes whose DRAIN is still in flight join the pending list (node name
    cleared) so scale-up provisions their replacement capacity before the
    node disappears. Matters most with --async-node-deletion, where drains
    span loops and the capacity is leaving while the pods still show as
    scheduled.

    The injected objects are COPIES (the live pods stay bound to the draining
    node — the reference likewise keeps the originals in the snapshot, where
    the ToBeDeleted taint stops duplicates landing back on the leaving node),
    cached by identity across loops so the incremental encoder sees a stable
    pending set while a drain is in progress. Copies are renamed
    "drained::<name>" — ':' cannot appear in real pod names, so the encoder's
    (namespace, name) keyspace stays collision-free while the original is
    still listed.

    A cached copy is INVALIDATED when the live pod is replaced (object
    identity change — the encoder's replace-on-update contract) or its
    request vector mutates in place, so scale-up never keeps provisioning
    for a stale spec while the drain is in flight."""

    def __init__(self, deletion_tracker):
        self.tracker = deletion_tracker          # actuator's NodeDeletionTracker
        # key -> (live source pod, request signature, injected copy)
        self._copies: dict[tuple[str, str], tuple[Pod, tuple, Pod]] = {}

    @staticmethod
    def _req_sig(p: Pod) -> tuple:
        return (tuple(sorted(p.requests.items())),
                tuple(sorted(p.overhead.items())))

    def process(self, pods, ctx):
        from kubernetes_autoscaler_tpu_torch.models.api import is_recreatable

        draining = set(self.tracker.drain_deletions_in_progress())
        if not draining:
            self._copies.clear()
            return pods
        injected: list[Pod] = []
        live_keys: set[tuple[str, str]] = set()
        for p in pods:
            if p.node_name not in draining:
                continue
            # deletion already under way -> the eviction/recreation path
            # owns it (currently_drained_nodes.go:57 skips these)
            if p.deletion_timestamp is not None:
                continue
            if not is_recreatable(p):
                continue
            key = (p.namespace, p.name)
            live_keys.add(key)
            sig = self._req_sig(p)
            entry = self._copies.get(key)
            if entry is not None:
                src, old_sig, cp = entry
                if src is not p or old_sig != sig:
                    entry = None    # live pod replaced/resized mid-drain
            if entry is None:
                import copy as _copy

                cp = _copy.copy(p)
                cp.name = f"drained::{p.name}"
                cp.uid = f"drained::{p.uid}"
                cp.node_name = ""                # ClearPodNodeNames
                cp.phase = "Pending"
                self._copies[key] = (p, sig, cp)
            injected.append(cp)
        for key in list(self._copies):
            if key not in live_keys:
                del self._copies[key]
        return pods + injected


class FilterExpendableProcessor:
    """reference: filter_out_expendable.go — drop pods below the priority
    cutoff (--expendable-pods-priority-cutoff)."""

    def process(self, pods, ctx):
        cut = ctx.options.expendable_pods_priority_cutoff
        return [p for p in pods if p.node_name or p.priority >= cut]


class FilterDaemonSetPodsProcessor:
    """reference: filter_out_daemon_sets.go — pending DS pods never trigger
    node-count scale-up (the DS controller owns them)."""

    def process(self, pods, ctx):
        return [p for p in pods if p.node_name or not p.is_daemonset()]


class FilterRecentPodsProcessor:
    """reference: --new-pod-scale-up-delay handling in listPods — very young
    pods wait a beat before triggering scale-up."""

    def __init__(self, creation_time: Callable[[Pod], float] | None = None):
        self.creation_time = creation_time

    def process(self, pods, ctx):
        delay = ctx.options.new_pod_scale_up_delay_s
        if delay <= 0 or self.creation_time is None:
            return pods
        return [
            p for p in pods
            if p.node_name or ctx.now - self.creation_time(p) >= delay
        ]


class TemplateNodeInfoProvider:
    """reference: MixedTemplateNodeInfoProvider (processors/nodeinfosprovider)
    — template from a real ready node exemplar when one exists (sanitized),
    else NodeGroup.TemplateNodeInfo()."""

    def template_for(self, group: NodeGroup, real_nodes: list[Node]) -> Node:
        for nd in real_nodes:
            if nd.ready:
                return self.sanitize(nd, group.id())
        return group.template_node_info()

    @staticmethod
    def sanitize(node: Node, group_id: str) -> Node:
        """reference: simulator/node_info_utils.go SanitizedNodeInfo — fresh
        identity, churn taints cleared."""
        from kubernetes_autoscaler_tpu_torch.models.api import (
            DELETION_CANDIDATE_TAINT,
            TO_BE_DELETED_TAINT,
        )

        labels = dict(node.labels)
        labels.pop("kubernetes.io/hostname", None)
        return Node(
            name=f"template-{group_id}",
            labels=labels,
            capacity=dict(node.capacity),
            allocatable=dict(node.allocatable),
            taints=[t for t in node.taints
                    if t.key not in (TO_BE_DELETED_TAINT, DELETION_CANDIDATE_TAINT)],
            ready=True,
        )


class CustomResourcesProcessor:
    """reference: processors/customresources/ — GPU nodes whose accelerator
    allocatable has not appeared yet count as unready (prevents premature
    scale-down/up decisions on booting GPU nodes)."""

    def __init__(self, gpu_label: str = "cloud.google.com/gke-accelerator",
                 gpu_resource: str = "nvidia.com/gpu"):
        self.gpu_label = gpu_label
        self.gpu_resource = gpu_resource

    def filter_ready(self, nodes: list[Node]) -> list[Node]:
        for nd in nodes:
            if nd.ready and self.gpu_label in nd.labels:
                if not nd.alloc_or_cap().get(self.gpu_resource):
                    nd.ready = False
        return nodes


class ActionableClusterProcessor:
    """reference: processors/actionablecluster — abort the loop early when the
    cluster has nothing to act on. Scale-from-zero with configured node groups
    is actionable (the reference supports 0-sized groups via templates)."""

    def should_abort(self, nodes: list[Node], node_groups: list[NodeGroup]) -> bool:
        return len(nodes) == 0 and len(node_groups) == 0


@dataclass
class AutoscalingProcessors:
    """The hook bundle threaded through RunOnce (reference:
    processors.AutoscalingProcessors, built by DefaultProcessors)."""

    pod_list_processors: list = field(default_factory=list)
    template_node_info_provider: TemplateNodeInfoProvider = field(
        default_factory=TemplateNodeInfoProvider
    )
    custom_resources: CustomResourcesProcessor = field(
        default_factory=CustomResourcesProcessor
    )
    actionable_cluster: ActionableClusterProcessor = field(
        default_factory=ActionableClusterProcessor
    )
    # observer callbacks (reference: ScaleUpStatusProcessor / ScaleDownStatusProcessor /
    # AutoscalingStatusProcessor / nodegroupchange observers)
    on_scale_up_status: list = field(default_factory=list)
    on_scale_down_status: list = field(default_factory=list)
    on_loop_start: list = field(default_factory=list)

    @classmethod
    def default(cls) -> "AutoscalingProcessors":
        return cls(
            pod_list_processors=[
                ClearTpuRequestsProcessor(),
                FilterExpendableProcessor(),
                FilterDaemonSetPodsProcessor(),
                FilterRecentPodsProcessor(),
            ]
        )

    def run_pod_list(self, pods: list[Pod], ctx: ProcessorContext) -> list[Pod]:
        for p in self.pod_list_processors:
            pods = p.process(pods, ctx)
        return pods

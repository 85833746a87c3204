"""Host-side object model: the minimal k8s-shaped surface the framework consumes.

The reference consumes full k8s API objects via client-go informers
(cluster-autoscaler/utils/kubernetes/). This framework is standalone, so it
defines a lightweight structural equivalent carrying exactly the fields the
simulation semantics read (the vendored-scheduler plugin inputs distilled in
SURVEY.md §7): resources, labels, selectors, taints/tolerations, affinity,
ports, topology keys, ownership/priority/annotations for drain classification.

These objects are the *boundary* format; they are encoded once per loop into
dense tensors (models/encode.py) and never consulted by the device code.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

# Taint effects (reference: k8s core/v1; consumed by TaintToleration filter).
NO_SCHEDULE = "NoSchedule"
NO_EXECUTE = "NoExecute"

# Well-known annotations the reference acts on
# (cluster-autoscaler/utils/drain/drain.go, simulator/drainability/rules/).
SAFE_TO_EVICT_KEY = "cluster-autoscaler.kubernetes.io/safe-to-evict"
# The taint CA itself places on nodes it deletes (reference: utils/taints/taints.go).
TO_BE_DELETED_TAINT = "ToBeDeletedByClusterAutoscaler"
# Set by lowering passes (DRA selectored claims, shared claims) whose
# constraint is not dense-encodable: forces the winner-verification tier.
HOST_CHECK_ANNOTATION = "autoscaler.x-k8s.io/host-check"

# Well-known topology keys (k8s core/v1). The dense encoding supports these
# two domain kinds; other topology keys route through the host-check tier.
HOSTNAME_KEY = "kubernetes.io/hostname"
ZONE_KEY = "topology.kubernetes.io/zone"
ZONE_KEY_BETA = "failure-domain.beta.kubernetes.io/zone"


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = NO_SCHEDULE


@dataclass(frozen=True)
class Toleration:
    key: str = ""                 # "" + Exists tolerates everything
    operator: str = "Equal"       # Equal | Exists
    value: str = ""
    effect: str = ""              # "" matches all effects


@dataclass(frozen=True)
class OwnerRef:
    kind: str = ""                # ReplicaSet | Job | DaemonSet | StatefulSet | Node(mirror) | ...
    name: str = ""
    uid: str = ""
    controller: bool = True


@dataclass
class AffinityTerm:
    """One required pod-(anti-)affinity term: selector over pod labels within a
    topology domain (reference: vendored InterPodAffinity filter semantics).

    `namespaces` empty means "the pod's own namespace" (k8s default) unless a
    `namespace_selector` is set, which selects namespaces by THEIR labels
    (reference: interpodaffinity/filtering.go:192 merges the selector into the
    namespace set using live Namespace objects; {} selects ALL namespaces).
    Evaluating it needs the cluster's namespace→labels map, so terms carrying
    one ride the host-check tier with the oracle given that map."""

    match_labels: dict[str, str] = field(default_factory=dict)
    topology_key: str = "kubernetes.io/hostname"
    namespaces: tuple[str, ...] = ()
    namespace_selector: Optional[dict[str, str]] = None


@dataclass
class TopologySpreadConstraint:
    """One `whenUnsatisfiable: DoNotSchedule` topologySpreadConstraint
    (reference: vendored PodTopologySpread filter semantics). An empty
    label_selector matches no pods (k8s semantics)."""

    max_skew: int = 1
    topology_key: str = "topology.kubernetes.io/zone"
    match_labels: dict[str, str] = field(default_factory=dict)
    # pod label keys whose (key, pod-value) pairs merge into the selector
    # (reference: podtopologyspread/common.go:96-104 mergeLabelSetWithSelector)
    match_label_keys: tuple[str, ...] = ()
    # global minimum becomes 0 while fewer domains exist than this
    # (filtering.go:54-67; nil → 1)
    min_domains: int = 1
    # node inclusion policies (common.go:42-56; defaults Honor / Ignore)
    node_affinity_policy: str = "Honor"    # Honor | Ignore
    node_taints_policy: str = "Ignore"     # Honor | Ignore

    def merged_selector(self, pod_labels: dict[str, str]) -> dict[str, str]:
        """match_labels + the pod's values for match_label_keys (a key absent
        from the pod contributes nothing — common.go:98-101)."""
        if not self.match_label_keys:
            return self.match_labels
        sel = dict(self.match_labels)
        for k in self.match_label_keys:
            if k in pod_labels:
                sel[k] = pod_labels[k]
        return sel


@dataclass
class NodeSelectorRequirement:
    key: str
    operator: str = "In"          # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: tuple[str, ...] = ()


@dataclass
class Pod:
    name: str
    namespace: str = "default"
    uid: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    # Sum of container requests, pre-aggregated (reference aggregates via
    # resourcehelpers; init-container max() rule applied by the caller/builder).
    requests: dict[str, float] = field(default_factory=dict)  # name -> amount (cpu in cores, memory in bytes)
    # spec.overhead (RuntimeClass pod overhead): ADDED to requests for every
    # fit decision (reference: noderesources/fit.go:299 — "resources defined
    # for Overhead should be added to the calculated Resource request sum")
    overhead: dict[str, float] = field(default_factory=dict)
    node_selector: dict[str, str] = field(default_factory=dict)
    # Single-term sugar: one ANDed requirement list. For the full k8s shape
    # (nodeSelectorTerms = OR of terms, each an AND of requirements) set
    # node_affinity_terms; when it is non-empty it supersedes this field.
    required_node_affinity: list[NodeSelectorRequirement] = field(default_factory=list)
    node_affinity_terms: list[list[NodeSelectorRequirement]] = field(default_factory=list)
    tolerations: list[Toleration] = field(default_factory=list)
    host_ports: tuple[tuple[int, str], ...] = ()              # (port, protocol)
    anti_affinity: list[AffinityTerm] = field(default_factory=list)
    pod_affinity: list[AffinityTerm] = field(default_factory=list)
    # Legacy single-constraint sugar (selector = the pod's own labels);
    # topology_spread supersedes both fields when non-empty.
    topology_spread_max_skew: int = 0                         # 0 = no constraint
    topology_spread_key: str = ""
    topology_spread: list[TopologySpreadConstraint] = field(default_factory=list)
    owner: Optional[OwnerRef] = None
    priority: int = 0
    node_name: str = ""                                       # scheduled destination ("" = pending)
    phase: str = "Pending"                                    # Pending|Running|Succeeded|Failed
    deletion_timestamp: Optional[float] = None
    # spec.terminationGracePeriodSeconds (None = kubelet default 30 s); the
    # actuator caps it by --max-graceful-termination-sec at eviction time
    termination_grace_s: Optional[float] = None
    restart_policy: str = "Always"
    volumes_with_local_storage: int = 0                       # emptyDir/hostPath count (drain rule)
    pvc_refs: tuple[str, ...] = ()
    # names of ResourceClaims this pod references beyond its owned (template)
    # claims — the shared-claim reference edge (reference:
    # pod.spec.resourceClaims; consumed by simulator/dynamicresources.py)
    resource_claims: tuple[str, ...] = ()

    def is_daemonset(self) -> bool:
        return self.owner is not None and self.owner.kind == "DaemonSet"

    def is_mirror(self) -> bool:
        return "kubernetes.io/config.mirror" in self.annotations

    def affinity_node_terms(self) -> list[list[NodeSelectorRequirement]]:
        """OR-of-AND nodeSelectorTerms (node_affinity_terms, or the single-term
        sugar wrapped). Empty list = no required node affinity."""
        if self.node_affinity_terms:
            return self.node_affinity_terms
        if self.required_node_affinity:
            return [self.required_node_affinity]
        return []

    def spread_constraints(self) -> list[TopologySpreadConstraint]:
        """All DoNotSchedule spread constraints, legacy sugar included (its
        selector is the pod's own labels — the dominant real-world shape)."""
        out = list(self.topology_spread)
        if not out and self.topology_spread_max_skew > 0:
            out.append(TopologySpreadConstraint(
                max_skew=self.topology_spread_max_skew,
                topology_key=self.topology_spread_key or "topology.kubernetes.io/zone",
                match_labels=dict(self.labels),
            ))
        return out


def labels_match(selector: dict[str, str], labels: dict[str, str]) -> bool:
    """match_labels subset test. An EMPTY selector matches no pods — both the
    spread and affinity encodings treat {} as 'selects nothing'."""
    if not selector:
        return False
    return all(labels.get(k) == v for k, v in selector.items())


def term_matches_pod(term: AffinityTerm, pod: "Pod", other: "Pod",
                     namespaces: dict[str, dict[str, str]] | None = None
                     ) -> bool:
    """Does `other` match `term` of `pod` (selector + namespace scoping)?

    `namespaces` maps namespace name → its labels, needed only when the term
    carries a namespace_selector (reference merges that selector into the
    namespace set from live Namespace objects, filtering.go:82,192). Without
    the map, a namespace_selector term matches conservatively: nothing — the
    dense/host tiers flag such terms needs_host_check and the control plane
    passes the map where the source provides one."""
    if term.namespace_selector is not None:
        if len(term.namespace_selector) == 0:
            # {} selects ALL namespaces (filtering.go:192 semantics) — no
            # namespace labels needed
            in_ns = True
        else:
            in_ns = other.namespace in term.namespaces
            if not in_ns and namespaces is not None:
                lbls = namespaces.get(other.namespace)
                in_ns = lbls is not None and labels_match(
                    term.namespace_selector, lbls)
        if not in_ns:
            return False
        return labels_match(term.match_labels, other.labels)
    scope = term.namespaces or (pod.namespace,)
    return other.namespace in scope and labels_match(term.match_labels, other.labels)


@dataclass
class Node:
    name: str
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    capacity: dict[str, float] = field(default_factory=dict)
    allocatable: dict[str, float] = field(default_factory=dict)
    taints: list[Taint] = field(default_factory=list)
    ready: bool = True
    unschedulable: bool = False
    creation_time: float = 0.0
    provider_id: str = ""

    def zone(self) -> str:
        return self.labels.get("topology.kubernetes.io/zone", self.labels.get("failure-domain.beta.kubernetes.io/zone", ""))

    def alloc_or_cap(self) -> dict[str, float]:
        return self.allocatable if self.allocatable else self.capacity

"""Serial exact predicate oracle — the test-time and host-check ground truth.

Plays the role the reference's Go path plays for its TPU sidecar (SURVEY.md §4
'oracle-checked against a serial reference implementation'): a direct,
unvectorized implementation of the simulable Filter subset with full string
semantics. The device kernels (ops/predicates.py, ops/constrained.py) are
property-tested against this module; the control plane also uses it to exactly
verify selected winners before actuation (the host-check tier for lossy
encodings).

Semantics distilled from the vendored kube-scheduler plugins the reference
runs (simulator/framework/handle.go:84-89 builds the in-tree registry):
NodeResourcesFit, NodeAffinity (full OR-of-terms + Gt/Lt), TaintToleration,
NodePorts, NodeUnschedulable, InterPodAffinity (required affinity and
anti-affinity, any topology key, first-pod exception), PodTopologySpread
(DoNotSchedule constraints).

Cluster-wide constraints (spread, inter-pod affinity) need the whole snapshot;
`check_pod_in_cluster` is the full-context entry. `check_pod_on_node` keeps
the single-node view for the plain predicates.
"""

from __future__ import annotations

from kubernetes_autoscaler_tpu_torch.models import resources as res
from kubernetes_autoscaler_tpu_torch.models.api import (
    HOSTNAME_KEY,
    NO_EXECUTE,
    NO_SCHEDULE,
    TO_BE_DELETED_TAINT,
    ZONE_KEY,
    ZONE_KEY_BETA,
    AffinityTerm,
    Node,
    Pod,
    labels_match,
    term_matches_pod,
)
from kubernetes_autoscaler_tpu_torch.models.encode import (
    node_capacity_vector,
    pod_request_vector,
)


def resources_fit(pod: Pod, node: Node,
                  registry: res.ExtendedResourceRegistry | None = None) -> bool:
    """Fit vs an empty node (resident-pod usage is handled in check_pod_on_node)."""
    registry = registry or res.ExtendedResourceRegistry()
    cap = node_capacity_vector(node, registry).astype(int)
    req, _ = pod_request_vector(pod, registry)
    return bool((req.astype(int) <= cap).all())


def _as_int(s: str) -> int | None:
    try:
        return int(s)
    except (TypeError, ValueError):
        return None


def requirement_matches(req, labels: dict[str, str]) -> bool:
    """One NodeSelectorRequirement vs a label map (k8s v1.NodeSelectorRequirement
    semantics, Gt/Lt included: both sides must parse as integers)."""
    val = labels.get(req.key)
    if req.operator == "In":
        return val is not None and val in req.values
    if req.operator == "NotIn":
        return val not in req.values
    if req.operator == "Exists":
        return req.key in labels
    if req.operator == "DoesNotExist":
        return req.key not in labels
    if req.operator in ("Gt", "Lt"):
        lhs = _as_int(val) if val is not None else None
        rhs = _as_int(req.values[0]) if req.values else None
        if lhs is None or rhs is None:
            return False
        return lhs > rhs if req.operator == "Gt" else lhs < rhs
    raise NotImplementedError(f"operator {req.operator}")


def selector_matches(pod: Pod, node: Node) -> bool:
    """nodeSelector AND required node affinity (OR over nodeSelectorTerms,
    AND within a term — k8s NodeAffinity semantics)."""
    for k, v in pod.node_selector.items():
        if node.labels.get(k) != v:
            return False
    terms = pod.affinity_node_terms()
    if not terms:
        return True
    return any(
        all(requirement_matches(r, node.labels) for r in term) for term in terms
    )


def taints_tolerated(pod: Pod, node: Node) -> bool:
    for t in node.taints:
        if t.effect not in (NO_SCHEDULE, NO_EXECUTE):
            continue
        tolerated = False
        for tol in pod.tolerations:
            if tol.effect and tol.effect != t.effect:
                continue
            if tol.operator == "Exists":
                if not tol.key or tol.key == t.key:
                    tolerated = True
                    break
            else:
                if tol.key == t.key and tol.value == t.value:
                    tolerated = True
                    break
        if not tolerated:
            return False
    return True


def ports_free(pod: Pod, pods_on_node: list[Pod]) -> bool:
    wanted = {(p, proto or "TCP") for p, proto in pod.host_ports}
    if not wanted:
        return True
    used = set()
    for q in pods_on_node:
        used.update((p, proto or "TCP") for p, proto in q.host_ports)
    return not (wanted & used)


def node_schedulable(node: Node) -> bool:
    if node.unschedulable or not node.ready:
        return False
    return all(t.key != TO_BE_DELETED_TAINT for t in node.taints)


# ---- topology helpers ----------------------------------------------------


def topology_value(node: Node, key: str) -> str | None:
    """The node's domain value for a topology key (None = key absent).

    The GA zone key falls back to the beta key; the hostname key falls back to
    the node name (kubelet always sets it; lightweight fixtures may not)."""
    if key == ZONE_KEY:
        return node.labels.get(ZONE_KEY, node.labels.get(ZONE_KEY_BETA))
    if key == HOSTNAME_KEY:
        return node.labels.get(HOSTNAME_KEY, node.name)
    return node.labels.get(key)


_term_matches_pod = term_matches_pod  # canonical impl lives in models/api.py


# ---- cluster-wide constraints -------------------------------------------


def spread_ok(
    pod: Pod,
    node: Node,
    nodes: list[Node],
    pods_by_node: dict[str, list[Pod]],
) -> bool:
    """PodTopologySpread DoNotSchedule check (vendored plugin semantics,
    podtopologyspread/{common,filtering}.go):

      * the constraint selector is match_labels merged with the pod's values
        for match_label_keys (common.go:96-104);
      * domains and their match counts are computed over nodes passing the
        node INCLUSION POLICIES — nodeAffinityPolicy=Honor (default) keeps
        only nodes matching the pod's nodeSelector/affinity,
        nodeTaintsPolicy=Honor keeps only nodes whose DoNotSchedule taints
        the pod tolerates (common.go:42-56);
      * global minimum = min match count over those domains, treated as 0
        while fewer domains exist than min_domains (filtering.go:54-67);
      * verdict: count(candidate's domain) + selfMatchNum - min <= max_skew,
        selfMatchNum = 1 iff the pod matches the (merged) selector
        (filtering.go:337-351). A candidate node without the topology key
        can never satisfy the constraint (filtering.go:330-335)."""
    for c in pod.spread_constraints():
        v_here = topology_value(node, c.topology_key)
        if v_here is None:
            return False  # node without the key cannot satisfy the constraint
        sel = c.merged_selector(pod.labels)
        counts: dict[str, int] = {}
        for nd in nodes:
            v = topology_value(nd, c.topology_key)
            if v is None:
                continue
            if c.node_affinity_policy != "Ignore" and not selector_matches(pod, nd):
                continue
            if c.node_taints_policy == "Honor" and not taints_tolerated(pod, nd):
                continue
            counts.setdefault(v, 0)
            for q in pods_by_node.get(nd.name, []):
                if q.namespace == pod.namespace and labels_match(sel, q.labels):
                    counts[v] += 1
        min_count = min(counts.values(), default=0)
        if len(counts) < max(int(c.min_domains), 1):
            min_count = 0  # not enough eligible domains yet (filtering.go:61)
        self_match = 1 if labels_match(sel, pod.labels) else 0
        if counts.get(v_here, 0) + self_match - min_count > c.max_skew:
            return False
    return True


def pod_affinity_ok(
    pod: Pod,
    node: Node,
    nodes: list[Node],
    pods_by_node: dict[str, list[Pod]],
    namespaces: dict[str, dict[str, str]] | None = None,
) -> bool:
    """Required inter-pod affinity: each term needs >=1 matching pod in the
    candidate node's topology domain. First-pod exception (vendored
    InterPodAffinity): a term with NO matching pod anywhere is satisfied if
    the incoming pod matches its own selector+namespaces."""
    for term in pod.pod_affinity:
        v_here = topology_value(node, term.topology_key)
        if v_here is None:
            return False
        matched_here = False
        matched_anywhere = False
        for nd in nodes:
            v = topology_value(nd, term.topology_key)
            for q in pods_by_node.get(nd.name, []):
                if _term_matches_pod(term, pod, q, namespaces):
                    matched_anywhere = True
                    if v == v_here:
                        matched_here = True
        if matched_here:
            continue
        if not matched_anywhere and _term_matches_pod(term, pod, pod,
                                                      namespaces):
            continue  # first-pod exception
        return False
    return True


def anti_affinity_ok(
    pod: Pod,
    node: Node,
    nodes: list[Node],
    pods_by_node: dict[str, list[Pod]],
    namespaces: dict[str, dict[str, str]] | None = None,
) -> bool:
    """Required inter-pod anti-affinity: no matching pod may share the
    candidate node's topology domain. A node without the key has no domain,
    so the term cannot be violated there (vendored plugin behavior)."""
    for term in pod.anti_affinity:
        v_here = topology_value(node, term.topology_key)
        if v_here is None:
            continue
        for nd in nodes:
            if topology_value(nd, term.topology_key) != v_here:
                continue
            for q in pods_by_node.get(nd.name, []):
                if _term_matches_pod(term, pod, q, namespaces):
                    return False
    return True


# ---- verdict entries -----------------------------------------------------


def group_pods_by_node(pods: list[Pod]) -> dict[str, list[Pod]]:
    by_node: dict[str, list[Pod]] = {}
    for p in pods:
        if p.node_name and p.phase not in ("Succeeded", "Failed"):
            by_node.setdefault(p.node_name, []).append(p)
    return by_node


def check_pod_on_node(
    pod: Pod,
    node: Node,
    pods_on_node: list[Pod],
    registry: res.ExtendedResourceRegistry | None = None,
) -> bool:
    """Single-node verdict: plain predicates plus the cluster constraints
    evaluated in a one-node world (exact when the pod has no cluster-wide
    constraints; call check_pod_in_cluster when it does)."""
    return check_pod_in_cluster(
        pod, node, [node], {node.name: list(pods_on_node)}, registry
    )


def check_pod_in_cluster(
    pod: Pod,
    node: Node,
    nodes: list[Node],
    pods_by_node: dict[str, list[Pod]],
    registry: res.ExtendedResourceRegistry | None = None,
    namespaces: dict[str, dict[str, str]] | None = None,
) -> bool:
    """Exact verdict with full cluster context: can `pod` schedule on `node`?

    `namespaces` (name → labels) makes affinity namespace_selector terms
    exact; without it such terms match nothing beyond their explicit
    namespace lists (models/api.term_matches_pod contract)."""
    registry = registry or res.ExtendedResourceRegistry()
    if not node_schedulable(node):
        return False
    if not selector_matches(pod, node):
        return False
    if not taints_tolerated(pod, node):
        return False
    pods_on_node = pods_by_node.get(node.name, [])
    if not ports_free(pod, pods_on_node):
        return False
    cap = node_capacity_vector(node, registry).astype(int)
    used = sum(
        (pod_request_vector(q, registry)[0].astype(int) for q in pods_on_node),
        start=cap * 0,
    )
    req, _ = pod_request_vector(pod, registry)
    if not bool((req.astype(int) <= cap - used).all()):
        return False
    if pod.anti_affinity and not anti_affinity_ok(pod, node, nodes,
                                                  pods_by_node, namespaces):
        return False
    if pod.pod_affinity and not pod_affinity_ok(pod, node, nodes,
                                                pods_by_node, namespaces):
        return False
    if not spread_ok(pod, node, nodes, pods_by_node):
        return False
    return True


def fresh_node_from_template(template: Node,
                             fresh_name: str = "template-fresh-node") -> Node:
    """Template → concrete fresh node, the estimator's sanitization
    (binpacking_estimator.go:330 via SanitizedNodeInfo). Shared by the
    oracle and the ConfirmOracle cache so their worlds cannot diverge."""
    return Node(
        name=fresh_name,
        labels={**template.labels, HOSTNAME_KEY: fresh_name},
        annotations=dict(template.annotations),
        capacity=dict(template.capacity),
        allocatable=dict(template.allocatable),
        taints=list(template.taints),
        ready=True,
        unschedulable=False,
    )


def check_pod_on_new_node(
    pod: Pod,
    template: Node,
    nodes: list[Node],
    pods_by_node: dict[str, list[Pod]],
    registry: res.ExtendedResourceRegistry | None = None,
    fresh_name: str = "template-fresh-node",
    namespaces: dict[str, dict[str, str]] | None = None,
    resident_pods: list[Pod] | None = None,
) -> bool:
    """Can `pod` schedule on a FRESH node stamped from `template`, given the
    current cluster? This is the scale-up winner-verification question
    (reference: the estimator schedules against a sanitized template NodeInfo
    added to the forked snapshot, binpacking_estimator.go:330).
    `resident_pods` pre-load the fresh node — DaemonSet overhead, the
    reference's DS-loaded template NodeInfos (node_info_utils.go:45)."""
    fresh = fresh_node_from_template(template, fresh_name)
    if resident_pods:
        pods_by_node = {**pods_by_node, fresh.name: list(resident_pods)}
    return check_pod_in_cluster(
        pod, fresh, list(nodes) + [fresh], pods_by_node, registry,
        namespaces=namespaces,
    )

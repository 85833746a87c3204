"""ConfirmOracle: the exact oracle with incrementally-maintained constraint
state, for the scale-down confirmation pass.

utils/oracle.check_pod_in_cluster is the ground truth, but its cluster-wide
constraint checks walk all nodes x resident pods PER CALL — O(N*P) — which
the confirmation pass may invoke per candidate destination. At 5k nodes x
50k pods one call is ~2.5e8 label matches: an unbounded host-check tier.
This cache makes each verdict
O(domains + pod fields) by:

  * precomputing, lazily per distinct constraint signature, the per-domain
    match counts (and per-term counts for (anti-)affinity) over the CURRENT
    world;
  * maintaining them under the pass's mutations — `move(pod, src, dst)` and
    `remove_node(name)` — instead of rescanning;
  * memoizing pod-class (namespace + labels) selector matches and
    node-inclusion verdicts.

Contract: `check(pod, node)` returns exactly what
oracle.check_pod_in_cluster(pod, node, alive_nodes, pods_by_node,
registry, namespaces) returns for the equivalent world.
tests/test_oracle_cache.py property-tests this under randomized
move/remove sequences.
"""

from __future__ import annotations

from kubernetes_autoscaler_tpu_torch.models import resources as res
from kubernetes_autoscaler_tpu_torch.models.api import (
    Node,
    Pod,
    labels_match,
    term_matches_pod,
)
from kubernetes_autoscaler_tpu_torch.utils import oracle as _o


def _pod_class(p: Pod) -> tuple:
    return (p.namespace, tuple(sorted(p.labels.items())))


def _term_sig(term, pod: Pod) -> tuple:
    return ("term", term.topology_key,
            tuple(sorted(term.match_labels.items())),
            term.namespaces or (pod.namespace,),
            tuple(sorted(term.namespace_selector.items()))
            if term.namespace_selector is not None else None)


def _spread_sig(c, pod: Pod) -> tuple:
    sel = c.merged_selector(pod.labels)
    return ("spread", c.topology_key, tuple(sorted(sel.items())),
            pod.namespace)


class _CountIndex:
    """Per-domain (and total) count of pods matching one selector/term.

    `node_filter` (spread indexes) restricts counting to nodes passing the
    constraint's inclusion policies — the vendored prefilter counts matches
    only on included nodes. `total` counts matches on ALL nodes regardless
    of topology key (the oracle's matched_anywhere semantics)."""

    __slots__ = ("by_domain", "total", "matcher", "topology_key",
                 "node_filter", "domains", "filter_memo")

    def __init__(self, topology_key, matcher, node_filter=None):
        self.topology_key = topology_key
        self.matcher = matcher        # Pod -> bool (memoized by caller)
        self.node_filter = node_filter  # Node -> bool (memoized), or None
        self.filter_memo: dict[str, bool] = {}
        self.by_domain: dict[str, int] = {}
        self.total = 0
        # domain value -> number of included alive nodes holding it (spread
        # indexes only; lets the skew check avoid any per-check node walk)
        self.domains: dict[str, int] = {}

    def add(self, pod: Pod, node: Node, sign: int) -> None:
        if not self.matcher(pod):
            return
        self.bump(node, sign)

    def bump(self, node: Node, sign: int) -> None:
        """add() for a pod the caller already knows matches."""
        self.total += sign
        if self.node_filter is not None and not self.node_filter(node):
            return
        v = _o.topology_value(node, self.topology_key)
        if v is None:
            return
        self.by_domain[v] = self.by_domain.get(v, 0) + sign


class ConfirmOracle:
    def __init__(
        self,
        nodes: list[Node],
        pods_by_node: dict[str, list[Pod]],
        registry: res.ExtendedResourceRegistry | None = None,
        namespaces: dict[str, dict[str, str]] | None = None,
    ):
        self.registry = registry or res.ExtendedResourceRegistry()
        self.namespaces = namespaces
        self.node_by_name: dict[str, Node] = {nd.name: nd for nd in nodes}
        self.pods_by_node = {k: list(v) for k, v in pods_by_node.items()}
        self._indexes: dict[tuple, _CountIndex] = {}
        # (sig-key, pod-class) -> bool match memo backing the indexes
        self._match_memo: dict[tuple, bool] = {}
        self._req_memo: dict[int, object] = {}   # id(pod) -> request vector
        # pod -> the indexes whose selector it matches (rebuilt when a new
        # index appears): makes move() O(matched) instead of O(indexes)
        self._indexes_version = 0
        self._pod_matched: dict[int, tuple[int, list]] = {}
        self._used: dict[str, object] = {}       # node name -> used vector
        self._cap_memo: dict[str, object] = {}   # node name -> capacity vec

    # ------------------------------------------------------------ mutations

    def move(self, pod: Pod, src: str, dst: str) -> None:
        """pod leaves node `src` (name, may be "") and lands on `dst`."""
        if src:
            lst = self.pods_by_node.get(src, [])
            if pod in lst:
                lst.remove(pod)
            nd = self.node_by_name.get(src)
            if nd is not None:
                for idx in self._matched_indexes(pod):
                    idx.bump(nd, -1)
                if src in self._used:
                    self._used[src] = self._used[src] - self._req(pod)
        if dst:
            self.pods_by_node.setdefault(dst, []).append(pod)
            nd = self.node_by_name.get(dst)
            if nd is not None:
                for idx in self._matched_indexes(pod):
                    idx.bump(nd, +1)
                if dst in self._used:
                    self._used[dst] = self._used[dst] + self._req(pod)

    def add_node(self, node: Node) -> None:
        """A node joins the world (e.g. a FRESH template instantiation for
        scale-up winner verification) — spread domain sets grow where the
        node passes a constraint's inclusion policies."""
        self.node_by_name[node.name] = node
        for idx in self._indexes.values():
            if idx.node_filter is not None and idx.node_filter(node):
                v = _o.topology_value(node, idx.topology_key)
                if v is not None:
                    idx.domains[v] = idx.domains.get(v, 0) + 1

    def check_on_new_node(self, pod: Pod, template: Node,
                          fresh_name: str = "template-fresh-node",
                          resident_pods: list | None = None) -> bool:
        """≡ oracle.check_pod_on_new_node over the cache's current world:
        can `pod` schedule on a FRESH node stamped from `template`?
        `resident_pods` pre-load the fresh node (DaemonSet overhead —
        reference template NodeInfos carry their DS pods)."""
        fresh = _o.fresh_node_from_template(template, fresh_name)
        self.add_node(fresh)
        if resident_pods:
            self.pods_by_node[fresh.name] = list(resident_pods)
            for q in resident_pods:          # symmetric with remove_node's -1
                for idx in self._matched_indexes(q):
                    idx.bump(fresh, +1)
        try:
            return self.check(pod, fresh)
        finally:
            self.remove_node(fresh.name)

    def remove_node(self, name: str) -> None:
        """Node leaves the world; any pods still listed on it vanish with it
        (the pass's by_node.pop semantics — daemonset leftovers)."""
        nd = self.node_by_name.pop(name, None)
        if nd is None:
            return
        for q in self.pods_by_node.pop(name, []):
            for idx in self._matched_indexes(q):
                idx.bump(nd, -1)
        self._used.pop(name, None)
        # NAME-keyed memos must die with the node: a different node may
        # reuse the name (the fresh template-node name does, every
        # check_on_new_node call) and would otherwise see stale verdicts
        self._cap_memo.pop(name, None)
        for idx in self._indexes.values():
            if idx.node_filter is not None and idx.node_filter(nd):
                v = _o.topology_value(nd, idx.topology_key)
                if v is not None and v in idx.domains:
                    idx.domains[v] -= 1
                    if idx.domains[v] <= 0:
                        del idx.domains[v]
            idx.filter_memo.pop(name, None)


    # ------------------------------------------------------------- internal

    def _matched_indexes(self, pod: Pod) -> list:
        ver, lst = self._pod_matched.get(id(pod), (-1, None))
        if ver != self._indexes_version:
            lst = [idx for idx in self._indexes.values()
                   if idx.matcher(pod)]
            self._pod_matched[id(pod)] = (self._indexes_version, lst)
        return lst

    def _index_for(self, sig: tuple, topology_key: str, matcher,
                   node_filter=None):
        idx = self._indexes.get(sig)
        if idx is None:
            # two-level memo: by pod IDENTITY first (one dict hit per add —
            # the pass calls move() per placement and every index sees every
            # moved pod), falling back to the pod-class memo so equal-labeled
            # pods share one selector evaluation
            cls_memo = self._match_memo
            id_memo: dict[int, bool] = {}

            def memo_matcher(q: Pod, _sig=sig, _m=matcher):
                hit = id_memo.get(id(q))
                if hit is None:
                    key = (_sig, _pod_class(q))
                    hit = cls_memo.get(key)
                    if hit is None:
                        hit = cls_memo[key] = _m(q)
                    id_memo[id(q)] = hit
                return hit

            filt = None
            fmemo: dict[str, bool] = {}
            if node_filter is not None:
                def filt(nd: Node, _f=node_filter, _memo=fmemo):
                    hit = _memo.get(nd.name)
                    if hit is None:
                        hit = _memo[nd.name] = _f(nd)
                    return hit

            idx = _CountIndex(topology_key, memo_matcher, filt)
            idx.filter_memo = fmemo
            for name, qs in self.pods_by_node.items():
                nd = self.node_by_name.get(name)
                if nd is None:
                    continue
                for q in qs:
                    idx.add(q, nd, +1)
            if filt is not None:  # spread index: precompute the domain set
                for nd in self.node_by_name.values():
                    if not filt(nd):
                        continue
                    v = _o.topology_value(nd, topology_key)
                    if v is not None:
                        idx.domains[v] = idx.domains.get(v, 0) + 1
            self._indexes[sig] = idx
            self._indexes_version += 1
        return idx

    def _included(self, pod: Pod, nd: Node, honor_affinity: bool,
                  honor_taints: bool) -> bool:
        if honor_affinity and not _o.selector_matches(pod, nd):
            return False
        if honor_taints and not _o.taints_tolerated(pod, nd):
            return False
        return True

    # --------------------------------------------------------------- checks

    def _spread_ok(self, pod: Pod, node: Node) -> bool:
        for c in pod.spread_constraints():
            v_here = _o.topology_value(node, c.topology_key)
            if v_here is None:
                return False
            sel = c.merged_selector(pod.labels)
            honor_aff = c.node_affinity_policy != "Ignore"
            honor_taints = c.node_taints_policy == "Honor"
            # inclusion fingerprint: pods of one equivalence class share
            # selector content, so indexes key on VALUES, not object ids
            incl_sig = (
                tuple(sorted(pod.node_selector.items())) if honor_aff else (),
                repr(pod.affinity_node_terms()) if honor_aff else "",
                repr([(t.key, t.operator, t.value, t.effect)
                      for t in pod.tolerations]) if honor_taints else "",
                honor_aff, honor_taints,
            )
            sig = _spread_sig(c, pod) + (incl_sig,)
            idx = self._index_for(
                sig, c.topology_key,
                lambda q, _sel=sel, _ns=pod.namespace:
                    q.namespace == _ns and labels_match(_sel, q.labels),
                node_filter=lambda nd, _p=pod, _a=honor_aff, _t=honor_taints:
                    self._included(_p, nd, _a, _t))
            min_count = min(
                (idx.by_domain.get(v, 0) for v in idx.domains), default=0)
            if len(idx.domains) < max(int(c.min_domains), 1):
                min_count = 0
            self_match = 1 if labels_match(sel, pod.labels) else 0
            if idx.by_domain.get(v_here, 0) + self_match - min_count \
                    > c.max_skew:
                return False
        return True

    def _anti_ok(self, pod: Pod, node: Node) -> bool:
        for term in pod.anti_affinity:
            v_here = _o.topology_value(node, term.topology_key)
            if v_here is None:
                continue
            idx = self._index_for(
                _term_sig(term, pod), term.topology_key,
                lambda q, _t=term, _p=pod:
                    term_matches_pod(_t, _p, q, self.namespaces))
            if idx.by_domain.get(v_here, 0) > 0:
                return False
        return True

    def _aff_ok(self, pod: Pod, node: Node) -> bool:
        for term in pod.pod_affinity:
            v_here = _o.topology_value(node, term.topology_key)
            if v_here is None:
                return False
            idx = self._index_for(
                _term_sig(term, pod), term.topology_key,
                lambda q, _t=term, _p=pod:
                    term_matches_pod(_t, _p, q, self.namespaces))
            if idx.by_domain.get(v_here, 0) > 0:
                continue
            if idx.total == 0 and term_matches_pod(term, pod, pod,
                                                   self.namespaces):
                continue  # first-pod exception
            return False
        return True

    def _req(self, pod: Pod):
        from kubernetes_autoscaler_tpu_torch.models.encode import pod_request_vector

        v = self._req_memo.get(id(pod))
        if v is None:
            v = self._req_memo[id(pod)] = \
                pod_request_vector(pod, self.registry)[0].astype(int)
        return v

    def check_constraints(self, pod: Pod, node: Node) -> bool:
        """Cluster-wide-constraint-only verdict — inter-pod (anti-)affinity
        and topology spread over the cache's current world, each O(domains)
        instead of O(nodes × pods). For callers that gate capacity,
        selector, taints and ports themselves (the scale-down planner's
        phantom injection runs those against device-true free capacity the
        oracle world cannot see). ≡ the corresponding utils/oracle checks:
        anti_affinity_ok ∧ pod_affinity_ok ∧ spread_ok."""
        if pod.anti_affinity and not self._anti_ok(pod, node):
            return False
        if pod.pod_affinity and not self._aff_ok(pod, node):
            return False
        return self._spread_ok(pod, node)

    def check(self, pod: Pod, node: Node) -> bool:
        """≡ oracle.check_pod_in_cluster over the cache's current world."""
        if not _o.node_schedulable(node):
            return False
        if not _o.selector_matches(pod, node):
            return False
        if not _o.taints_tolerated(pod, node):
            return False
        pods_on_node = self.pods_by_node.get(node.name, [])
        if not _o.ports_free(pod, pods_on_node):
            return False
        from kubernetes_autoscaler_tpu_torch.models.encode import (
            node_capacity_vector,
        )

        cap = self._cap_memo.get(node.name)
        if cap is None:
            cap = self._cap_memo[node.name] = \
                node_capacity_vector(node, self.registry).astype(int)
        used = self._used.get(node.name)
        if used is None:
            used = self._used[node.name] = sum(
                (self._req(q) for q in pods_on_node), start=cap * 0)
        if not bool((self._req(pod) <= cap - used).all()):
            return False
        if pod.anti_affinity and not self._anti_ok(pod, node):
            return False
        if pod.pod_affinity and not self._aff_ok(pod, node):
            return False
        if not self._spread_ok(pod, node):
            return False
        return True

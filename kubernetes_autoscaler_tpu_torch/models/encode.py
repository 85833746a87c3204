"""Host-side lowering: k8s-shaped objects → dense snapshot tensors.

This is the one-time-per-loop string→tensor boundary. Reference counterpart:
PredicateSnapshot.SetClusterState (simulator/clustersnapshot/predicate/
predicate_snapshot.go:72-120), which rebuilds NodeInfos from API objects each
loop; here the rebuild produces numpy arrays that become torch tensors on
the requested device. A copy of the reference package's models/encode.py;
only the tensor construction differs.

Encoding conventions (consumed by ops/predicates.py):
  * labels     — each node label (k,v) contributes fold32("k=v") and fold32("k\\x01")
                 (the key-marker enables Exists selectors).
  * selectors  — nodeSelector and required node-affinity lower to ANDed
                 requirements, each an OR over alternative pair hashes (In with
                 multiple values); NotIn/DoesNotExist lower to must-be-absent
                 hashes. Anything wider than the padding dims flags
                 needs_host_check instead of dropping a constraint.
  * taints     — exact item fold32("k\\0v\\0e") plus key item fold32("k\\0e");
                 a toleration covers a taint via the exact hash (Equal) or the
                 key hash (Exists). Empty-effect tolerations expand to both
                 NoSchedule and NoExecute. PreferNoSchedule never blocks
                 (scheduler semantics — it is a score, not a filter).
  * hostPorts  — fold32("port/proto"); conflict = any overlap with the node's
                 occupied-port set.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

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
from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    DEFAULT_DIMS,
    AffinityPlanes,
    Dims,
    NodeGroupTensors,
    NodeTensors,
    PodGroupTensors,
    ScheduledPodTensors,
    pad_to,
)
from kubernetes_autoscaler_tpu_torch.device import resolve_device
from kubernetes_autoscaler_tpu_torch.utils.hashing import fold32

_KEY_MARK = "\x01"


def _tensors(cls, device, **arrays):
    """Build one of the port's tensor dataclasses from host numpy arrays on
    `device` (the reference's `_device` seam, which ships jnp arrays)."""
    return cls(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()})


def _label_items(labels: dict[str, str]) -> list[int]:
    out = []
    for k, v in labels.items():
        out.append(fold32(f"{k}={v}"))
        out.append(fold32(k + _KEY_MARK))
    return out


def _taint_hashes(key: str, value: str, effect: str) -> tuple[int, int]:
    return fold32(f"{key}\0{value}\0{effect}"), fold32(f"{key}\0{effect}")


def _fill(row: np.ndarray, items: list[int]) -> bool:
    """Fill a padded int32 row; returns False on overflow (caller flags host check)."""
    k = min(len(items), row.shape[0])
    if k:
        row[:k] = np.array(items[:k], dtype=np.int32)
    return len(items) <= row.shape[0]


@dataclass
class ZoneTable:
    """Interns zone strings to small ids; id 0 is reserved for 'no zone'."""

    ids: dict[str, int] = field(default_factory=dict)

    def id_for(self, zone: str) -> int:
        if not zone:
            return 0
        if zone not in self.ids:
            self.ids[zone] = len(self.ids) + 1
        return self.ids[zone]


def pod_request_vector(
    pod: Pod, registry: res.ExtendedResourceRegistry
) -> tuple[np.ndarray, bool]:
    """Pod spec → (int32[R], lossy). Requests round up (resources.py convention).

    lossy=True when an extended resource did not fit the slot registry — the
    pod must then be verified host-side (needs_host_check)."""
    v = np.zeros((res.NUM_RESOURCES,), dtype=np.int64)
    v[res.PODS] = 1
    lossy = False
    # pod overhead adds to every fit decision (noderesources/fit.go:299)
    items = list(pod.requests.items()) + list(pod.overhead.items())
    for name, amount in items:
        if name == "cpu":
            v[res.CPU] += res.cpu_request_to_milli(amount)
        elif name == "memory":
            v[res.MEMORY] += res.mem_request_to_mib(amount)
        elif name == "ephemeral-storage":
            v[res.EPHEMERAL] += res.mem_request_to_mib(amount)
        else:
            slot = registry.try_slot_for(name)
            if slot is None:
                lossy = True
            else:
                v[slot] += int(np.ceil(amount))
    return v.astype(np.int32), lossy


def node_capacity_vector(node: Node, registry: res.ExtendedResourceRegistry) -> np.ndarray:
    """Node allocatable → int32[R]; capacities round down.

    Unmappable extended resources are dropped — the node simply offers less,
    which can only under-schedule (the conservative direction)."""
    v = np.zeros((res.NUM_RESOURCES,), dtype=np.int64)
    for name, amount in node.alloc_or_cap().items():
        if name == "cpu":
            v[res.CPU] = res.cpu_capacity_to_milli(amount)
        elif name == "memory":
            v[res.MEMORY] = res.mem_capacity_to_mib(amount)
        elif name == "ephemeral-storage":
            v[res.EPHEMERAL] = res.mem_capacity_to_mib(amount)
        elif name == "pods":
            v[res.PODS] = int(amount)
        else:
            slot = registry.try_slot_for(name)
            if slot is not None:
                v[slot] = int(amount)
    if v[res.PODS] == 0:
        v[res.PODS] = 110  # kubelet default max-pods
    return v.astype(np.int32)


@dataclass
class _PodSpecEncoding:
    sel_req: np.ndarray
    sel_neg: np.ndarray
    tol_exact: np.ndarray
    tol_key: np.ndarray
    tolerate_all: bool
    port_hash: np.ndarray
    anti_affinity_self: bool
    lossy: bool
    # topology-coupled constraints (kinds: 0 none, 1 hostname, 2 zone)
    spread_kind: int = 0
    max_skew: int = 0
    spread_self: bool = False
    spread_selector: dict[str, str] | None = None
    aff_kind: int = 0
    aff_self: bool = False
    aff_term: AffinityTerm | None = None
    anti_self_zone: bool = False
    anti_host_terms: list[AffinityTerm] = field(default_factory=list)
    anti_zone_terms: list[AffinityTerm] = field(default_factory=list)
    exemplar: Pod | None = None


def _domain_kind(topology_key: str) -> int:
    """1 = hostname domain, 2 = zone domain, 0 = not dense-encodable."""
    if topology_key == HOSTNAME_KEY:
        return 1
    if topology_key in (ZONE_KEY, ZONE_KEY_BETA):
        return 2
    return 0


def _encode_pod_spec(pod: Pod, dims: Dims) -> _PodSpecEncoding:
    from kubernetes_autoscaler_tpu_torch.models.api import HOST_CHECK_ANNOTATION

    # lowering passes (DRA/CSI) flag constraints the dense encoding can't carry
    lossy = pod.annotations.get(HOST_CHECK_ANNOTATION) == "true"
    # --- selector terms (AND of ORs) ---
    sel_req = np.zeros((dims.max_sel_terms, dims.max_sel_alts), dtype=np.int32)
    sel_neg = np.zeros((dims.max_neg_terms,), dtype=np.int32)
    terms: list[list[int]] = [[fold32(f"{k}={v}")] for k, v in sorted(pod.node_selector.items())]
    negs: list[int] = []
    # NodeAffinity is OR-of-AND (nodeSelectorTerms); the dense AND-of-OR shape
    # carries a single term exactly. Multi-term OR lowers exactly in the
    # common shape where every term is ONE positive requirement — that IS a
    # single OR row (alternatives across keys). Anything wider is dropped
    # from the dense mask (over-admits — never silently blocks) and flagged
    # host-check; the oracle (utils/oracle.selector_matches) is exact there.
    affinity_terms = pod.affinity_node_terms()
    if len(affinity_terms) > 1:
        flat_alts: list[int] | None = []
        for term in affinity_terms:
            if (len(term) == 1 and term[0].operator in ("In", "Exists")
                    and flat_alts is not None):
                r0 = term[0]
                if r0.operator == "In":
                    flat_alts.extend(fold32(f"{r0.key}={v}") for v in r0.values)
                else:
                    flat_alts.append(fold32(r0.key + _KEY_MARK))
            else:
                flat_alts = None
        if flat_alts is not None and len(flat_alts) <= dims.max_sel_alts:
            terms.append(flat_alts)
        else:
            lossy = True
        affinity_terms = []
    for r in (affinity_terms[0] if affinity_terms else []):
        if r.operator == "In":
            terms.append([fold32(f"{r.key}={v}") for v in r.values])
        elif r.operator == "Exists":
            terms.append([fold32(r.key + _KEY_MARK)])
        elif r.operator == "DoesNotExist":
            negs.append(fold32(r.key + _KEY_MARK))
        elif r.operator == "NotIn":
            negs.extend(fold32(f"{r.key}={v}") for v in r.values)
        else:  # Gt/Lt: numeric label compare — host-check tier (oracle exact)
            lossy = True
    if len(terms) > dims.max_sel_terms or len(negs) > dims.max_neg_terms:
        lossy = True
    for i, alts in enumerate(terms[: dims.max_sel_terms]):
        if len(alts) > dims.max_sel_alts:
            lossy = True
        k = min(len(alts), dims.max_sel_alts)
        sel_req[i, :k] = np.array(alts[:k], dtype=np.int32)
    _fill(sel_neg, negs)

    # --- tolerations ---
    tol_exact = np.zeros((dims.max_tolerations,), dtype=np.int32)
    tol_key = np.zeros((dims.max_tolerations,), dtype=np.int32)
    tolerate_all = False
    ex, ky = [], []
    for t in pod.tolerations:
        effects = [t.effect] if t.effect else [NO_SCHEDULE, NO_EXECUTE]
        if t.operator == "Exists":
            if not t.key:
                # empty key = any taint key. With no effect it is the true
                # tolerate-everything flag. Scoped to NoSchedule/NoExecute the
                # dense encoding cannot express "any key of effect e" (taint
                # hashes are key-scoped) → over-admit + host-check (oracle is
                # exact). Scoped to PreferNoSchedule it covers no filterable
                # taint at all → ignore. Found by tests/test_predicate_fuzz.py.
                if not t.effect:
                    tolerate_all = True
                elif t.effect in (NO_SCHEDULE, NO_EXECUTE):
                    tolerate_all = True
                    lossy = True
                continue
            for e in effects:
                ky.append(fold32(f"{t.key}\0{e}"))
        else:
            for e in effects:
                ex.append(fold32(f"{t.key}\0{t.value}\0{e}"))
    if not (_fill(tol_exact, ex) and _fill(tol_key, ky)):
        lossy = True

    # --- host ports ---
    port_hash = np.zeros((dims.max_pod_ports,), dtype=np.int32)
    if not _fill(port_hash, [fold32(f"{p}/{proto or 'TCP'}") for p, proto in pod.host_ports]):
        lossy = True

    # --- inter-pod (anti-)affinity + topology spread: the dense path covers
    #     hostname- and zone-domain terms via resident-count planes
    #     (AffinityPlanes) and placement-coupled waves (ops/constrained.py);
    #     other topology keys / extra terms go through the host-check tier
    #     (SURVEY.md §7 hard part: these break pods×nodes independence). ---
    enc = _PodSpecEncoding(
        sel_req, sel_neg, tol_exact, tol_key, tolerate_all, port_hash,
        anti_affinity_self=False, lossy=lossy, exemplar=pod,
    )
    for term in pod.anti_affinity:
        kind = _domain_kind(term.topology_key)
        if kind == 0:
            enc.lossy = True
            continue
        if term.namespace_selector is not None:
            # namespace-by-labels scoping needs the Namespace world — the
            # dense planes under-count (conservative: over-admits) and the
            # winner rides the host-check tier with the namespaces map
            enc.lossy = True
        self_match = term_matches_pod(term, pod, pod)
        if kind == 1:
            enc.anti_affinity_self = enc.anti_affinity_self or self_match
            enc.anti_host_terms.append(term)
        else:
            enc.anti_self_zone = enc.anti_self_zone or self_match
            enc.anti_zone_terms.append(term)

    if pod.pod_affinity:
        if len(pod.pod_affinity) > 1:
            enc.lossy = True
        term = pod.pod_affinity[0]
        if term.namespace_selector is not None:
            enc.lossy = True
        kind = _domain_kind(term.topology_key)
        if kind == 0:
            enc.lossy = True
        else:
            enc.aff_kind = kind
            enc.aff_term = term
            enc.aff_self = term_matches_pod(term, pod, pod)

    spreads = pod.spread_constraints()
    if spreads:
        if len(spreads) > 1:
            enc.lossy = True  # first constraint enforced densely; rest host-checked
        c = spreads[0]
        kind = _domain_kind(c.topology_key)
        if kind == 0:
            enc.lossy = True
        else:
            enc.spread_kind = kind
            enc.max_skew = max(int(c.max_skew), 1)
            # matchLabelKeys lowers EXACTLY: the merged selector is static
            # per pod (common.go:96-104)
            sel = c.merged_selector(pod.labels)
            enc.spread_selector = dict(sel)
            enc.spread_self = labels_match(sel, pod.labels)
            # knobs the dense kernel does not model (it assumes the default
            # policies: affinity Honor via s_elig, taints Ignore; and a
            # global minimum over currently-populated domains ≡ minDomains=1)
            # → exact host-check tier
            if (int(c.min_domains) > 1
                    or c.node_affinity_policy == "Ignore"
                    or c.node_taints_policy == "Honor"):
                enc.lossy = True
    return enc


def resident_plane_hits(
    enc_row: _PodSpecEncoding, q: Pod
) -> tuple[int, int, int, int]:
    """One resident pod's contribution to group `enc_row`'s constraint planes:
    (aff_cnt, anti_host_cnt, anti_zone_cnt, spread_cnt) 0/1 hits. Shared by
    the full encode (summed over all residents) and the incremental encoder
    (applied as ±1 deltas on resident add/remove)."""
    ex = enc_row.exemplar
    if ex is None:
        return (0, 0, 0, 0)
    aff = int(enc_row.aff_term is not None
              and term_matches_pod(enc_row.aff_term, ex, q))
    anti_h = int(any(term_matches_pod(t, ex, q) for t in enc_row.anti_host_terms))
    anti_z = int(any(term_matches_pod(t, ex, q) for t in enc_row.anti_zone_terms))
    spread = int(enc_row.spread_selector is not None
                 and q.namespace == ex.namespace
                 and labels_match(enc_row.spread_selector, q.labels))
    return (aff, anti_h, anti_z, spread)


def cross_group_hostcheck(
    row_encodings: list[tuple[np.ndarray, _PodSpecEncoding]],
    pending_rows: list[int],
) -> set[int]:
    """Rows whose constraint selectors match pods of a DIFFERENT pending group:
    their placements couple mid-pack, which the device does not model →
    host-check tier. Shared by encode_cluster and the incremental encoder."""
    out: set[int] = set()
    for grow in pending_rows:
        enc_g = row_encodings[grow][1]
        ex_g = enc_g.exemplar
        if ex_g is None:
            continue
        selectors: list[tuple[AffinityTerm | None, dict[str, str] | None]] = []
        if enc_g.spread_kind:
            selectors.append((None, enc_g.spread_selector))
        selectors.extend(
            (t, None) for t in enc_g.anti_host_terms + enc_g.anti_zone_terms)
        if enc_g.aff_term is not None and not enc_g.aff_self:
            # positive affinity satisfiable only by ANOTHER pending group's
            # placements: not modeled on device → host-check tier
            selectors.append((enc_g.aff_term, None))
        if not selectors:
            continue
        for hrow in pending_rows:
            if hrow == grow:
                continue
            ex_h = row_encodings[hrow][1].exemplar
            if ex_h is None:
                continue
            for term, sel in selectors:
                if term is not None:
                    hit = term_matches_pod(term, ex_g, ex_h)
                else:
                    hit = (ex_h.namespace == ex_g.namespace
                           and labels_match(sel or {}, ex_h.labels))
                if hit:
                    out.add(grow)
                    break
            if grow in out:
                break
    return out


def apply_zone_overflow(enc: _PodSpecEncoding, zones_fit: bool) -> None:
    """When the cluster has more zones than Dims.max_zones, zone-scoped
    constraints cannot ride the dense planes: drop the zone coupling and flag
    host-check (the oracle is exact there). Shared with the incremental path."""
    uses_zones = (enc.spread_kind == 2 or enc.aff_kind == 2
                  or enc.anti_self_zone or enc.anti_zone_terms)
    if uses_zones and not zones_fit:
        enc.lossy = True
        if enc.spread_kind == 2:
            enc.spread_kind = 0
        if enc.aff_kind == 2:
            enc.aff_kind = 0
        enc.anti_self_zone = False
        enc.anti_zone_terms = []


def equivalence_key(pod: Pod) -> int:
    """Pods with equal keys are schedulable-equivalent (reference:
    core/scaleup/equivalence/groups.go:40 — controller UID + drop-irrelevant-
    fields spec hash). We hash the predicate-relevant spec directly."""
    parts = [
        pod.namespace,
        # labels matter to equivalence now: they are the targets of affinity/
        # spread selectors and decide self-matching
        repr(sorted(pod.labels.items())),
        repr(sorted(pod.requests.items())),
        repr(sorted(pod.overhead.items())),
        repr(sorted(pod.node_selector.items())),
        repr([[(r.key, r.operator, tuple(r.values)) for r in term]
              for term in pod.affinity_node_terms()]),
        repr([(t.key, t.operator, t.value, t.effect) for t in pod.tolerations]),
        repr(pod.host_ports),
        repr([(sorted(t.match_labels.items()), t.topology_key, t.namespaces,
               sorted(t.namespace_selector.items())
               if t.namespace_selector is not None else None)
              for t in pod.anti_affinity]),
        repr([(sorted(t.match_labels.items()), t.topology_key, t.namespaces,
               sorted(t.namespace_selector.items())
               if t.namespace_selector is not None else None)
              for t in pod.pod_affinity]),
        repr([(c.max_skew, c.topology_key, sorted(c.match_labels.items()),
               c.match_label_keys, c.min_domains,
               c.node_affinity_policy, c.node_taints_policy)
              for c in pod.spread_constraints()]),
        pod.owner.uid if pod.owner else pod.name,
    ]
    return fold32("|".join(parts))


def encode_node_row(
    nd: Node,
    registry: res.ExtendedResourceRegistry,
    zone_table: ZoneTable,
    dims: Dims,
) -> dict[str, np.ndarray | int | bool]:
    """Encode one node into its tensor row pieces (shared by encode_cluster and
    the snapshot's incremental add-node path, simulator/snapshot.py)."""
    label_hash = np.zeros((dims.max_labels,), np.int32)
    taint_exact = np.zeros((dims.max_taints,), np.int32)
    taint_key = np.zeros((dims.max_taints,), np.int32)
    if not _fill(label_hash, _label_items(nd.labels)):
        # Losing label hashes would create false "does not match" — the one
        # direction the encoding contract forbids. Fail fast; the caller
        # re-encodes with a larger Dims.max_labels.
        raise ValueError(
            f"node {nd.name!r}: {len(nd.labels)} labels overflow "
            f"Dims.max_labels={dims.max_labels} (2 slots per label)"
        )
    tx, tk = [], []
    blocked = False
    for t in nd.taints:
        if t.effect not in (NO_SCHEDULE, NO_EXECUTE):
            continue  # PreferNoSchedule: score-only, never filters
        if t.key == TO_BE_DELETED_TAINT:
            blocked = True
        e, k = _taint_hashes(t.key, t.value, t.effect)
        tx.append(e)
        tk.append(k)
    if not (_fill(taint_exact, tx) and _fill(taint_key, tk)):
        # Losing a taint would silently ADMIT intolerant pods — fail fast.
        raise ValueError(
            f"node {nd.name!r}: {len(tx)} filterable taints overflow "
            f"Dims.max_taints={dims.max_taints}"
        )
    return {
        "cap": node_capacity_vector(nd, registry),
        "label_hash": label_hash,
        "taint_exact": taint_exact,
        "taint_key": taint_key,
        "zone_id": zone_table.id_for(nd.zone()),
        "ready": nd.ready,
        "schedulable": not nd.unschedulable and not blocked,
    }


@dataclass
class EncodedCluster:
    """Host handle for one encoded snapshot: tensors + name/index maps."""

    nodes: NodeTensors
    specs: PodGroupTensors          # spec table; `count` counts PENDING pods per row
    scheduled: ScheduledPodTensors  # resident pods, group_ref → specs row
    node_names: list[str]
    node_index: dict[str, int]
    zone_table: ZoneTable
    registry: res.ExtendedResourceRegistry
    dims: Dims
    group_pods: list[list[int]]     # specs row → indices into `pending_pods`
    pending_pods: list[Pod]
    scheduled_pods: list[Pod]
    planes: AffinityPlanes | None = None
    has_constraints: bool = False   # any group carries a topology-coupled
                                    # constraint (selects the constrained
                                    # kernel variants — a STATIC choice)
    node_objs: list[Node] = field(default_factory=list)
    # namespace name → labels (from the source's Namespace objects, when it
    # provides them) — makes affinity namespace_selector terms exact in the
    # host-check tier (reference merges the selector into the namespace set
    # from live Namespace objects, interpodaffinity/filtering.go:192)
    namespaces: dict[str, dict[str, str]] | None = None
    device: torch.device | None = None


def encode_cluster(
    nodes: list[Node],
    pods: list[Pod],
    registry: res.ExtendedResourceRegistry | None = None,
    dims: Dims = DEFAULT_DIMS,
    node_group_ids: dict[str, int] | None = None,
    node_bucket: int = 64,
    group_bucket: int = 64,
    pod_bucket: int = 256,
    namespaces: dict[str, dict[str, str]] | None = None,
    device: str | torch.device | None = None,
) -> EncodedCluster:
    """Lower a (nodes, pods) world into one EncodedCluster on `device`
    (None = CUDA; raises without one unless `device="cpu"`).

    Pods with node_name set and a live node become `scheduled` rows and charge
    their node's alloc/ports; the rest become pending equivalence groups.
    """
    device = resolve_device(device)
    registry = registry or res.ExtendedResourceRegistry()
    zone_table = ZoneTable()
    node_group_ids = node_group_ids or {}

    node_index = {nd.name: i for i, nd in enumerate(nodes)}
    # Terminal pods neither charge capacity nor ask for it (reference: the
    # kube listers feeding RunOnce filter Succeeded/Failed, and drainability's
    # terminal rule skips them — utils/kubernetes + drainability/rules/terminal).
    live = [p for p in pods if p.phase not in ("Succeeded", "Failed")]
    pending = [p for p in live if not p.node_name or p.node_name not in node_index]
    resident = [p for p in live if p.node_name in node_index]

    # ---- nodes ----
    n_pad = pad_to(len(nodes), node_bucket)
    r = res.NUM_RESOURCES
    cap = np.zeros((n_pad, r), np.int32)
    alloc = np.zeros((n_pad, r), np.int32)
    label_hash = np.zeros((n_pad, dims.max_labels), np.int32)
    taint_exact = np.zeros((n_pad, dims.max_taints), np.int32)
    taint_key = np.zeros((n_pad, dims.max_taints), np.int32)
    used_ports = np.zeros((n_pad, dims.max_node_ports), np.int32)
    zone_id = np.zeros((n_pad,), np.int32)
    group_id = np.full((n_pad,), -1, np.int32)
    ready = np.zeros((n_pad,), bool)
    schedulable = np.zeros((n_pad,), bool)
    valid = np.zeros((n_pad,), bool)

    for i, nd in enumerate(nodes):
        row = encode_node_row(nd, registry, zone_table, dims)
        cap[i] = row["cap"]
        label_hash[i] = row["label_hash"]
        taint_exact[i] = row["taint_exact"]
        taint_key[i] = row["taint_key"]
        zone_id[i] = row["zone_id"]
        group_id[i] = node_group_ids.get(nd.name, -1)
        ready[i] = row["ready"]
        schedulable[i] = row["schedulable"]
        valid[i] = True

    # ---- resident pods: charge alloc + ports; collect spec rows ----
    spec_rows: dict[int, int] = {}       # equivalence key -> specs row
    row_encodings: list[tuple[np.ndarray, _PodSpecEncoding]] = []
    row_pending_count: list[int] = []
    group_pods: list[list[int]] = []

    def row_for(pod: Pod) -> int:
        key = equivalence_key(pod)
        if key not in spec_rows:
            spec_rows[key] = len(row_encodings)
            req, req_lossy = pod_request_vector(pod, registry)
            spec = _encode_pod_spec(pod, dims)
            spec.lossy = spec.lossy or req_lossy
            row_encodings.append((req, spec))
            row_pending_count.append(0)
            group_pods.append([])
        return spec_rows[key]

    p_pad = pad_to(len(resident), pod_bucket)
    s_req = np.zeros((p_pad, r), np.int32)
    s_node = np.full((p_pad,), -1, np.int32)
    s_group = np.zeros((p_pad,), np.int32)
    s_movable = np.zeros((p_pad,), bool)
    s_blocks = np.zeros((p_pad,), bool)
    s_valid = np.zeros((p_pad,), bool)
    node_port_lists: dict[int, list[int]] = {}

    for j, pod in enumerate(resident):
        ni = node_index[pod.node_name]
        req, _ = pod_request_vector(pod, registry)
        alloc[ni] += req
        for p, proto in pod.host_ports:
            node_port_lists.setdefault(ni, []).append(fold32(f"{p}/{proto or 'TCP'}"))
        s_req[j] = req
        s_node[j] = ni
        s_group[j] = row_for(pod)
        # Conservative default: every resident pod blocks draining until the
        # drainability rules (simulator/drainability/rules.py) classify it —
        # an unclassified snapshot must never report nodes as freely drainable.
        s_blocks[j] = True
        s_valid[j] = True
    for ni, ports in node_port_lists.items():
        if not _fill(used_ports[ni], ports):
            # Losing an occupied port would admit conflicting pods — fail fast.
            raise ValueError(
                f"node index {ni}: {len(ports)} occupied hostPorts overflow "
                f"Dims.max_node_ports={dims.max_node_ports}"
            )

    # ---- pending pods → groups ----
    for idx, pod in enumerate(pending):
        row = row_for(pod)
        row_pending_count[row] += 1
        group_pods[row].append(idx)

    g_pad = pad_to(max(len(row_encodings), 1), group_bucket)
    g_req = np.zeros((g_pad, r), np.int32)
    g_count = np.zeros((g_pad,), np.int32)
    g_sel_req = np.zeros((g_pad, dims.max_sel_terms, dims.max_sel_alts), np.int32)
    g_sel_neg = np.zeros((g_pad, dims.max_neg_terms), np.int32)
    g_tol_exact = np.zeros((g_pad, dims.max_tolerations), np.int32)
    g_tol_key = np.zeros((g_pad, dims.max_tolerations), np.int32)
    g_tol_all = np.zeros((g_pad,), bool)
    g_ports = np.zeros((g_pad, dims.max_pod_ports), np.int32)
    g_anti_self = np.zeros((g_pad,), bool)
    g_valid = np.zeros((g_pad,), bool)
    g_hostcheck = np.zeros((g_pad,), bool)
    g_spread_kind = np.zeros((g_pad,), np.int32)
    g_max_skew = np.zeros((g_pad,), np.int32)
    g_spread_self = np.zeros((g_pad,), bool)
    g_aff_kind = np.zeros((g_pad,), np.int32)
    g_aff_self = np.zeros((g_pad,), bool)
    g_aff_any = np.zeros((g_pad,), bool)
    g_anti_self_zone = np.zeros((g_pad,), bool)

    # Zone-scoped constraints need every zone to fit the static Z dim; when
    # the cluster has more zones, those groups fall back to host-check (the
    # oracle is exact) and the device drops the zone coupling.
    zones_fit = len(zone_table.ids) + 1 <= dims.max_zones

    for row, (req, enc) in enumerate(row_encodings):
        g_req[row] = req
        g_count[row] = row_pending_count[row]
        g_sel_req[row] = enc.sel_req
        g_sel_neg[row] = enc.sel_neg
        g_tol_exact[row] = enc.tol_exact
        g_tol_key[row] = enc.tol_key
        g_tol_all[row] = enc.tolerate_all
        g_ports[row] = enc.port_hash
        g_anti_self[row] = enc.anti_affinity_self
        g_valid[row] = True
        apply_zone_overflow(enc, zones_fit)
        g_spread_kind[row] = enc.spread_kind
        g_max_skew[row] = enc.max_skew
        g_spread_self[row] = enc.spread_self
        g_aff_kind[row] = enc.aff_kind
        g_aff_self[row] = enc.aff_self
        g_anti_self_zone[row] = enc.anti_self_zone
        g_hostcheck[row] = enc.lossy

    # ---- cross-group coupling: a selector of group g matching pods of a
    # DIFFERENT pending group is not modeled on device (placements of h would
    # change g's constraint state mid-pack) -> host-check tier. ----
    pending_rows = [row for row in range(len(row_encodings))
                    if row_pending_count[row] > 0]
    for grow in cross_group_hostcheck(row_encodings, pending_rows):
        g_hostcheck[grow] = True

    # ---- resident-derived constraint planes ----
    constrained_rows = [
        row for row, (_, enc) in enumerate(row_encodings)
        if (enc.spread_kind or enc.aff_kind or enc.anti_host_terms
            or enc.anti_zone_terms)
    ]
    p_aff = np.zeros((g_pad, n_pad), np.int32)
    p_anti_host = np.zeros((g_pad, n_pad), np.int32)
    p_anti_zone = np.zeros((g_pad, n_pad), np.int32)
    p_spread = np.zeros((g_pad, n_pad), np.int32)
    if constrained_rows:
        for q in resident:
            ni = node_index[q.node_name]
            for row in constrained_rows:
                aff, anti_h, anti_z, spread = resident_plane_hits(
                    row_encodings[row][1], q)
                p_aff[row, ni] += aff
                p_anti_host[row, ni] += anti_h
                p_anti_zone[row, ni] += anti_z
                p_spread[row, ni] += spread
        g_aff_any[:] = p_aff.sum(axis=1) > 0
    has_constraints = bool(constrained_rows)

    out_nodes = _tensors(
        NodeTensors, device,
        cap=cap, alloc=alloc, label_hash=label_hash, taint_exact=taint_exact,
        taint_key=taint_key, used_ports=used_ports, zone_id=zone_id,
        group_id=group_id, ready=ready, schedulable=schedulable, valid=valid,
    )
    out_specs = _tensors(
        PodGroupTensors, device,
        req=g_req, count=g_count, sel_req=g_sel_req, sel_neg=g_sel_neg,
        tol_exact=g_tol_exact, tol_key=g_tol_key, tolerate_all=g_tol_all,
        port_hash=g_ports, anti_affinity_self=g_anti_self, valid=g_valid,
        needs_host_check=g_hostcheck,
        spread_kind=g_spread_kind, max_skew=g_max_skew,
        spread_self=g_spread_self, aff_kind=g_aff_kind, aff_self=g_aff_self,
        aff_match_any=g_aff_any, anti_self_zone=g_anti_self_zone,
    )
    out_sched = _tensors(
        ScheduledPodTensors, device,
        req=s_req, node_idx=s_node, group_ref=s_group, movable=s_movable,
        blocks=s_blocks, valid=s_valid,
    )
    out_planes = _tensors(
        AffinityPlanes, device,
        aff_cnt=p_aff, anti_host_cnt=p_anti_host,
        anti_zone_cnt=p_anti_zone, spread_cnt=p_spread,
    )
    return EncodedCluster(
        nodes=out_nodes,
        specs=out_specs,
        scheduled=out_sched,
        node_names=[nd.name for nd in nodes],
        node_index=node_index,
        zone_table=zone_table,
        registry=registry,
        dims=dims,
        group_pods=group_pods,
        pending_pods=pending,
        scheduled_pods=resident,
        planes=out_planes,
        has_constraints=has_constraints,
        node_objs=list(nodes),
        namespaces=namespaces,
        device=device,
    )


def encode_node_groups(
    templates: list[tuple[Node, int, float]],
    registry: res.ExtendedResourceRegistry,
    zone_table: ZoneTable,
    dims: Dims = DEFAULT_DIMS,
    bucket: int = 8,
    device: str | torch.device | None = None,
) -> NodeGroupTensors:
    """Lower node-group templates (template node, max_new, price/node) to tensors.

    Reference: MixedTemplateNodeInfoProvider (processors/nodeinfosprovider)
    produces a NodeInfo per group; sanitization (simulator/node_info_utils.go)
    is mirrored by the caller passing a clean template Node. `device`: None =
    CUDA, as in encode_cluster. (The reference's `daemonsets` overhead charge
    is not ported yet.)
    """
    device = resolve_device(device)
    ng_pad = pad_to(max(len(templates), 1), bucket)
    r = res.NUM_RESOURCES
    cap = np.zeros((ng_pad, r), np.int32)
    label_hash = np.zeros((ng_pad, dims.max_labels), np.int32)
    taint_exact = np.zeros((ng_pad, dims.max_taints), np.int32)
    taint_key = np.zeros((ng_pad, dims.max_taints), np.int32)
    zone_id = np.zeros((ng_pad,), np.int32)
    max_new = np.zeros((ng_pad,), np.int32)
    price = np.zeros((ng_pad,), np.float32)
    valid = np.zeros((ng_pad,), bool)
    for i, (tmpl, mx, pr) in enumerate(templates):
        cap[i] = node_capacity_vector(tmpl, registry)
        _fill(label_hash[i], _label_items(tmpl.labels))
        tx, tk = [], []
        for t in tmpl.taints:
            if t.effect not in (NO_SCHEDULE, NO_EXECUTE):
                continue
            e, k = _taint_hashes(t.key, t.value, t.effect)
            tx.append(e)
            tk.append(k)
        _fill(taint_exact[i], tx)
        _fill(taint_key[i], tk)
        zone_id[i] = zone_table.id_for(tmpl.zone())
        max_new[i] = mx
        price[i] = pr
        valid[i] = True
    return _tensors(
        NodeGroupTensors, device,
        cap=cap, label_hash=label_hash, taint_exact=taint_exact, taint_key=taint_key,
        zone_id=zone_id, max_new=max_new, price_per_node=price, valid=valid,
    )

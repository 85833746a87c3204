"""Batched scheduler-predicate evaluation: the pods×nodes feasibility mask.

Counterpart of the reference package's `ops/predicates.py`: the boolean
plane, the uint16 reason planes (`reason_mask`, `reason_mask_for_groups`)
and their host-side numpy twins (`host_predicate_row`, `host_reason_row`,
`summarize_reason_row`). Implemented filter semantics: NodeResourcesFit,
NodeUnschedulable, NodeAffinity + nodeSelector, TaintToleration, NodePorts,
and the readiness/validity gates. Every tensor function here is one call of
`ops/kernels/predicate_kernel.plane`: one launch of `csrc/predicates.cu` on
the card, the plain version (the reference's loops over the static padding
dims, one broadcast over [G, N] a step) on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    NodeTensors,
    PodGroupTensors,
)
from kubernetes_autoscaler_tpu_torch.models.resources import (
    CPU,
    EPHEMERAL,
    MEMORY,
    NUM_STANDARD,
    PODS,
)
from kubernetes_autoscaler_tpu_torch.ops.kernels import predicate_kernel as _pk
from kubernetes_autoscaler_tpu_torch.ops.kernels.predicate_kernel import (
    REASON_CPU,
    REASON_EPHEMERAL,
    REASON_EXTENDED,
    REASON_GROUP_INVALID,
    REASON_MEMORY,
    REASON_NODE_UNAVAILABLE,
    REASON_PODS,
    REASON_PORTS,
    REASON_SELECTOR,
    REASON_TAINT,
)

# ---- the REASON plane: packed per-(pod-group × node) refusal bits ----
#
# Each bit names the Filter that refused the pair; 0 ⇔ feasible (the
# invariant `feasibility_mask == (reason_mask == 0)` is property-tested in
# tests/test_predicate_fuzz.py). uint16 keeps the whole G×N plane one quarter
# the size of the int32 predicate inputs. The taxonomy follows the reference's
# NoScaleUp/event reasons (estimator skip reasons + the per-filter verdicts
# its scheduler framework reports) — see docs/OBSERVABILITY.md for the table.
# The bit values live beside the kernel that writes them
# (ops/kernels/predicate_kernel.py).

# ordered: the first set bit in this order is the headline reason
REASON_BITS = (
    (REASON_CPU, "cpu"),
    (REASON_MEMORY, "memory"),
    (REASON_EPHEMERAL, "ephemeral-storage"),
    (REASON_PODS, "pod-capacity"),
    (REASON_EXTENDED, "extended-resource"),
    (REASON_SELECTOR, "selector"),
    (REASON_TAINT, "taint"),
    (REASON_PORTS, "ports"),
    (REASON_NODE_UNAVAILABLE, "node-unavailable"),
    (REASON_GROUP_INVALID, "invalid-group"),
)
REASON_NAMES = {bit: name for bit, name in REASON_BITS}

# host-level summary reasons (not kernel bits):
# - a refused group with no valid node/template column at all (reference:
#   the NoScaleUp "no node group can help" event)
NO_NODE_IN_GROUP = "no-node-in-group"
# - a refused group with at least one fully-feasible column: the constraint
#   planes admit it somewhere, so the refusal came from option capping
#   (max_new / limiter stack / bins crowded out by earlier FFD groups) —
#   the reference's "max node group size reached"-family skip reasons
CAPPED_BY_LIMITS = "capped-by-limits"


def resources_fit(nodes: NodeTensors, specs: PodGroupTensors) -> torch.Tensor:
    """bool[G, N]: req <= cap - alloc on every resource slot."""
    return _pk.plane(nodes, specs, _pk.RESOURCES)


def selector_match(node_labels: torch.Tensor,
                   specs: PodGroupTensors) -> torch.Tensor:
    """bool[G, N]: every ANDed requirement has ≥1 alternative present, and no
    must-be-absent hash is present. node_labels: i32[N, L]."""
    return _pk.plane(_pk.NodePlanes(label_hash=node_labels), specs,
                     _pk.SELECTOR)


def taints_tolerated(taint_exact: torch.Tensor, taint_key: torch.Tensor,
                     specs: PodGroupTensors) -> torch.Tensor:
    """bool[G, N]: every NoSchedule/NoExecute taint is covered by a toleration
    (exact hash = Equal, key hash = Exists, or the tolerate-everything flag).
    taint_exact/taint_key: i32[N, T]."""
    return _pk.plane(_pk.NodePlanes(taint_exact=taint_exact,
                                    taint_key=taint_key), specs, _pk.TAINTS)


def ports_free(used_ports: torch.Tensor, specs: PodGroupTensors) -> torch.Tensor:
    """bool[G, N]: none of the pod's hostPorts collide with occupied ports."""
    return _pk.plane(_pk.NodePlanes(used_ports=used_ports), specs, _pk.PORTS)


def host_predicate_row(label_hash: np.ndarray, taint_exact: np.ndarray,
                       taint_key: np.ndarray, spec) -> np.ndarray:
    """Host-side (numpy) selector + taint feasibility row for ONE encoded pod
    spec against the node planes: bool[N].

    The single-pod mirror of `selector_match` and `taints_tolerated` above,
    evaluated on the encoder's host mirrors with no device dispatch — the
    scale-down planner's phantom-injection prefilter runs it per evicted pod
    so the exact oracle only sees the surviving nodes. Exact for non-lossy
    specs (same hash-equality contract as the device planes); callers must
    not prefilter with it when `spec.lossy` is set, because a lossy encoding
    may under-admit and the prefilter must never exclude a node the oracle
    would accept.

    `spec` is a models.encode._PodSpecEncoding (numpy fields)."""
    n = label_hash.shape[0]
    ok = np.ones((n,), dtype=bool)
    # selector: every active AND-term needs >= 1 alternative hash present
    for s in range(spec.sel_req.shape[0]):
        alts = spec.sel_req[s]
        alts = alts[alts != 0]
        if alts.size == 0:
            continue
        ok &= np.isin(label_hash, alts).any(axis=1)
    negs = spec.sel_neg[spec.sel_neg != 0]
    if negs.size:
        ok &= ~np.isin(label_hash, negs).any(axis=1)
    # taints: every active NoSchedule/NoExecute taint must be covered by an
    # exact (key,value,effect) or key-scoped (key,effect) toleration hash
    if not spec.tolerate_all:
        tol_ex = spec.tol_exact[spec.tol_exact != 0]
        tol_ky = spec.tol_key[spec.tol_key != 0]
        active = taint_exact != 0                       # bool[N, T]
        covered = np.isin(taint_exact, tol_ex) | np.isin(taint_key, tol_ky)
        ok &= (~active | covered).all(axis=1)
    return ok


def host_reason_row(planes: dict, gi: int,
                    check_resources: bool = True) -> np.ndarray:
    """Host-side (numpy) twin of ONE `reason_mask` row: uint16[N] packed
    refusal bits for pod-group `gi` against every node, computed from the
    incremental encoder's host mirrors with no device dispatch.

    This is the shadow-audit oracle (audit/shadow.py): the device evaluates
    `reason_mask` over its resident planes, this recomputes the same bits
    from the same logical inputs on the host — bit-for-bit equal on a
    healthy backend (pinned by tests/test_shadow_audit.py the same way the
    fuzz suite pins `feasible ⇔ reason_bits == 0`). A silently miscompiled
    predicate kernel, a corrupted resident plane, or a bad fetch shows up
    as a per-bit diff the audit can name.

    `planes` is the mirror dict (models/incremental.IncrementalEncoder._m
    keys: "nodes.*" / "specs.*"). Same hash-equality contract as
    `host_predicate_row` — the comparison is at the ENCODING level, so it
    is exact for lossy specs too (both sides see the same hashes)."""
    lh = planes["nodes.label_hash"]
    te = planes["nodes.taint_exact"]
    tk = planes["nodes.taint_key"]
    up = planes["nodes.used_ports"]
    n = lh.shape[0]
    bits = np.zeros((n,), dtype=np.uint16)
    # selector: every active AND-term needs >= 1 alternative present, and
    # no must-be-absent hash present (host_predicate_row's contract)
    sel_ok = np.ones((n,), dtype=bool)
    sel_req = planes["specs.sel_req"][gi]
    for s in range(sel_req.shape[0]):
        alts = sel_req[s]
        alts = alts[alts != 0]
        if alts.size:
            sel_ok &= np.isin(lh, alts).any(axis=1)
    negs = planes["specs.sel_neg"][gi]
    negs = negs[negs != 0]
    if negs.size:
        sel_ok &= ~np.isin(lh, negs).any(axis=1)
    bits |= np.where(~sel_ok, np.uint16(REASON_SELECTOR), np.uint16(0))
    # taints: every active taint covered by an exact or key-scoped hash
    if bool(planes["specs.tolerate_all"][gi]):
        t_ok = np.ones((n,), dtype=bool)
    else:
        tol_ex = planes["specs.tol_exact"][gi]
        tol_ex = tol_ex[tol_ex != 0]
        tol_ky = planes["specs.tol_key"][gi]
        tol_ky = tol_ky[tol_ky != 0]
        active = te != 0
        covered = np.isin(te, tol_ex) | np.isin(tk, tol_ky)
        t_ok = (~active | covered).all(axis=1)
    bits |= np.where(~t_ok, np.uint16(REASON_TAINT), np.uint16(0))
    # ports: any of the spec's hostPort hashes already occupied
    ph = planes["specs.port_hash"][gi]
    ph = ph[ph != 0]
    if ph.size:
        conflict = np.isin(up, ph).any(axis=1)
        bits |= np.where(conflict, np.uint16(REASON_PORTS), np.uint16(0))
    if check_resources:
        free = (planes["nodes.cap"].astype(np.int64)
                - planes["nodes.alloc"].astype(np.int64))
        lack = planes["specs.req"][gi].astype(np.int64)[None, :] > free
        bits |= np.where(lack[:, CPU], np.uint16(REASON_CPU), np.uint16(0))
        bits |= np.where(lack[:, MEMORY], np.uint16(REASON_MEMORY),
                         np.uint16(0))
        bits |= np.where(lack[:, EPHEMERAL], np.uint16(REASON_EPHEMERAL),
                         np.uint16(0))
        bits |= np.where(lack[:, PODS], np.uint16(REASON_PODS), np.uint16(0))
        bits |= np.where(lack[:, NUM_STANDARD:].any(axis=-1),
                         np.uint16(REASON_EXTENDED), np.uint16(0))
    gate = (planes["nodes.valid"].astype(bool)
            & planes["nodes.ready"].astype(bool)
            & planes["nodes.schedulable"].astype(bool))
    bits |= np.where(~gate, np.uint16(REASON_NODE_UNAVAILABLE), np.uint16(0))
    if not bool(planes["specs.valid"][gi]):
        bits |= np.uint16(REASON_GROUP_INVALID)
    return bits


def _checks(check_resources: bool) -> int:
    return _pk.STATIC | (_pk.RESOURCES if check_resources else 0)


def feasibility_mask(nodes: NodeTensors, specs: PodGroupTensors,
                     check_resources: bool = True) -> torch.Tensor:
    """The full predicate plane: bool[G, N]. `check_resources=False` gives the
    placement-independent mask (the packer checks capacity itself)."""
    return _pk.plane(nodes, specs, _checks(check_resources))


def reason_mask(
    nodes: NodeTensors,
    specs: PodGroupTensors,
    check_resources: bool = True,
) -> torch.Tensor:
    """The reason variant of `feasibility_mask`: uint16[G, N] packed refusal
    bits, one per (pod-equivalence-group, node). 0 ⇔ the pair is feasible —
    bit-for-bit `feasibility_mask(...) == (reason_mask(...) == 0)` for the
    same `check_resources`.

    Not on the hot path: callers dispatch it only over already-refused
    groups / failed candidates (`reason_mask_for_groups` below)."""
    return _pk.plane(nodes, specs, _checks(check_resources), bits=True)


def reason_mask_for_groups(
    nodes: NodeTensors,
    specs: PodGroupTensors,
    group_mask: torch.Tensor,      # bool[G] — only these rows carry bits
    check_resources: bool = True,
) -> torch.Tensor:
    """The lazy masked dispatch: reason bits for the refused groups only
    (other rows zeroed so host consumers can't misread padding). Called once
    per *refused* loop; a fully-schedulable loop never calls it — callers
    count calls under `reason_extraction_dispatches`."""
    return _pk.plane(nodes, specs, _checks(check_resources), bits=True,
                     group_mask=group_mask)


def reason_bit_names(bits: int) -> list[str]:
    """Decode one packed value into its ordered reason names."""
    return [name for bit, name in REASON_BITS if bits & bit]


def summarize_reason_row(row: np.ndarray, col_valid: np.ndarray
                         ) -> tuple[str, dict[str, int]]:
    """Host-side summary of ONE refused group's reason row: the headline
    reason plus per-constraint refused-column counts.

    `col_valid` masks real columns (live nodes, or `groups.valid` when the
    row came from the template plane). Headline selection: no valid column
    at all means nothing could ever host the group ("no-node-in-group"); a
    fully-feasible column (bits == 0) means the constraint planes admit the
    group somewhere and the refusal came from option capping
    ("capped-by-limits"); a constraint refusing on EVERY valid column
    (bitwise AND) is the single blocking reason; otherwise no one constraint
    explains the refusal alone — "multiple-constraints"."""
    cols = np.asarray(row)[np.asarray(col_valid, bool)]
    if cols.size == 0:
        return NO_NODE_IN_GROUP, {}
    counts = {
        name: int(n)
        for bit, name in REASON_BITS
        if (n := int((cols & bit != 0).sum()))
    }
    if (cols == 0).any():
        return CAPPED_BY_LIMITS, counts
    common = int(np.bitwise_and.reduce(cols))
    for bit, name in REASON_BITS:
        if common & bit:
            return name, counts
    return "multiple-constraints", counts

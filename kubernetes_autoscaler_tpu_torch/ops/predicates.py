"""Batched scheduler-predicate evaluation: the pods×nodes feasibility mask.

Counterpart of the reference package's `ops/predicates.py` (boolean plane
only; the reason planes come later). Implemented filter semantics:
NodeResourcesFit, NodeUnschedulable, NodeAffinity + nodeSelector,
TaintToleration, NodePorts, and the readiness/validity gates. Every loop is
over a static padding dim; each step is one broadcast over [G, N].
"""

from __future__ import annotations

import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    NodeTensors,
    PodGroupTensors,
)


def _any_eq(table: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """table: i32[N, K] hash slots, h: i32[G] probes → bool[G, N] membership.

    0 probes never match (0 is the padding sentinel and never a valid hash).
    Builds a G×N×K bool temporary."""
    hit = (table[None, :, :] == h[:, None, None]).any(dim=-1)
    return hit & (h != 0)[:, None]


def resources_fit(nodes: NodeTensors, specs: PodGroupTensors) -> torch.Tensor:
    """bool[G, N]: req <= cap - alloc on every resource slot."""
    free = nodes.free()
    return (specs.req[:, None, :] <= free[None, :, :]).all(dim=-1)


def selector_match(node_labels: torch.Tensor,
                   specs: PodGroupTensors) -> torch.Tensor:
    """bool[G, N]: every ANDed requirement has ≥1 alternative present, and no
    must-be-absent hash is present. node_labels: i32[N, L]."""
    g = specs.sel_req.shape[0]
    n = node_labels.shape[0]
    ok = torch.ones((g, n), dtype=torch.bool, device=node_labels.device)
    s_terms, s_alts = specs.sel_req.shape[1], specs.sel_req.shape[2]
    for s in range(s_terms):
        term = specs.sel_req[:, s, :]                      # i32[G, A]
        term_active = (term != 0).any(dim=-1)              # bool[G]
        sat = torch.zeros((g, n), dtype=torch.bool, device=node_labels.device)
        for a in range(s_alts):
            sat = sat | _any_eq(node_labels, term[:, a])
        ok = ok & (~term_active[:, None] | sat)
    for s in range(specs.sel_neg.shape[1]):
        ok = ok & ~_any_eq(node_labels, specs.sel_neg[:, s])
    return ok


def taints_tolerated(taint_exact: torch.Tensor, taint_key: torch.Tensor,
                     specs: PodGroupTensors) -> torch.Tensor:
    """bool[G, N]: every NoSchedule/NoExecute taint is covered by a toleration
    (exact hash = Equal, key hash = Exists, or the tolerate-everything flag).
    taint_exact/taint_key: i32[N, T]."""
    g = specs.tol_exact.shape[0]
    n = taint_exact.shape[0]
    ok = torch.ones((g, n), dtype=torch.bool, device=taint_exact.device)
    for t in range(taint_exact.shape[1]):
        te = taint_exact[:, t]                              # i32[N]
        tk = taint_key[:, t]
        active = te != 0                                    # bool[N]
        covered = specs.tolerate_all[:, None].expand(g, n)
        for tl in range(specs.tol_exact.shape[1]):
            covered = covered | ((specs.tol_exact[:, tl][:, None] == te[None, :])
                                 & active[None, :])
            covered = covered | ((specs.tol_key[:, tl][:, None] == tk[None, :])
                                 & (tk != 0)[None, :])
        ok = ok & (~active[None, :] | covered)
    return ok


def ports_free(used_ports: torch.Tensor, specs: PodGroupTensors) -> torch.Tensor:
    """bool[G, N]: none of the pod's hostPorts collide with occupied ports."""
    g = specs.port_hash.shape[0]
    n = used_ports.shape[0]
    conflict = torch.zeros((g, n), dtype=torch.bool, device=used_ports.device)
    for pp in range(specs.port_hash.shape[1]):
        conflict = conflict | _any_eq(used_ports, specs.port_hash[:, pp])
    return ~conflict


def feasibility_mask(nodes: NodeTensors, specs: PodGroupTensors,
                     check_resources: bool = True) -> torch.Tensor:
    """The full predicate plane: bool[G, N]. `check_resources=False` gives the
    placement-independent mask (the packer checks capacity itself)."""
    mask = selector_match(nodes.label_hash, specs)
    mask = mask & taints_tolerated(nodes.taint_exact, nodes.taint_key, specs)
    mask = mask & ports_free(nodes.used_ports, specs)
    if check_resources:
        mask = mask & resources_fit(nodes, specs)
    gate = nodes.valid & nodes.ready & nodes.schedulable
    mask = mask & gate[None, :]
    return mask & specs.valid[:, None]

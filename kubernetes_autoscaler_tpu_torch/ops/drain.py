"""Batched node-removal (drain) simulation for scale-down.

Counterpart of the reference package's `ops/drain.py` (RemovalResult,
simulate_removals) for the unconstrained case. Every candidate node is
simulated independently, in chunks of candidates:

  1. its resident movable pods are gathered from a by-node sorted window and
     compacted into at most K per-group counts,
  2. a K-step first-fit places each group's count onto the destination
     nodes with the cumulative-fit trick (a Python loop over K on
     [C, N, R] tensors; the reference leaves this step to XLA),
  3. per-pod destinations are rebuilt from the groups' cumulative placement
     curves by `searchsorted`, one call per slot.

A node with more than `max_groups_per_node` distinct shapes is reported
undrainable (its overflow pods count in n_failed). The chunk size changes
memory only, never results; by default it is worked out from
`CHUNK_BYTES` and the world's N and R (`default_chunk`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    NodeTensors,
    PodGroupTensors,
    ScheduledPodTensors,
    _Tree,
)
from kubernetes_autoscaler_tpu_torch.ops.pack import fit_count
from kubernetes_autoscaler_tpu_torch.ops.predicates import feasibility_mask
from kubernetes_autoscaler_tpu_torch.ops.schedule import resident_group_counts

# memory budget of one [C, N, R] int32 free-capacity plane of the first-fit
CHUNK_BYTES = 256 * 2 ** 20


def default_chunk(c_total: int, n: int, r: int) -> int:
    """Candidates per chunk: as many as keep one [C, N, R] int32 plane
    within CHUNK_BYTES, split evenly over the chunks that needs."""
    most = max(1, CHUNK_BYTES // (n * r * 4))
    n_chunks = max(1, -(-c_total // most))
    return max(1, -(-c_total // n_chunks))


@dataclass(frozen=True)
class RemovalResult(_Tree):
    drainable: torch.Tensor    # bool[C] all movable pods re-placed & no blockers
    has_blocker: torch.Tensor  # bool[C] a pod forbids draining
    n_moved: torch.Tensor      # i32[C] pods that found a new home
    n_failed: torch.Tensor     # i32[C] movable pods with no destination
    dest_node: torch.Tensor    # i32[C, MPN] destination per pod slot (-1 = none)
    pod_slot: torch.Tensor     # i32[C, MPN] ScheduledPodTensors index per slot
    feas: torch.Tensor         # bool[G, N] shared predicate plane (pre-capacity)


def simulate_removals(
    nodes: NodeTensors,
    specs: PodGroupTensors,
    scheduled: ScheduledPodTensors,
    candidates: torch.Tensor,     # i32[C] node indices to try draining
    dest_allowed: torch.Tensor,   # bool[N] allowed destination nodes
    max_pods_per_node: int = 128,
    chunk: int | None = None,
    max_groups_per_node: int = 16,
) -> RemovalResult:
    """Simulate removing every candidate node independently. `chunk`
    (candidates per chunk) defaults to `default_chunk`."""
    n = nodes.n
    g_total = specs.g
    mpn = max_pods_per_node
    kk = max_groups_per_node
    dev = nodes.cap.device
    i32 = torch.int32

    # shared predicate plane, placement-independent
    feas_gn = feasibility_mask(nodes, specs, check_resources=False)
    resident = resident_group_counts(scheduled, g_total, n)
    feas_gn = feas_gn & ~(specs.anti_affinity_self[:, None] & (resident > 0))
    limit_g = specs.one_per_node()
    free0 = nodes.free()
    dest_ok = dest_allowed & nodes.valid & nodes.ready & nodes.schedulable
    node_ids = torch.arange(n, dtype=i32, device=dev)

    # resident pods sorted by node: each candidate's pods are one window
    sort_key = torch.where(scheduled.valid, scheduled.node_idx, n + 1)
    pod_order = torch.argsort(sort_key, stable=True).to(i32)
    sorted_nodes = sort_key[pod_order]
    starts = torch.searchsorted(sorted_nodes, node_ids).to(i32)
    pad_order = torch.cat([pod_order, torch.full((mpn,), -1, dtype=i32, device=dev)])
    window = torch.arange(mpn, dtype=torch.int64, device=dev)
    slot_k = torch.arange(kk, device=dev)
    group_ids = torch.arange(g_total, dtype=i32, device=dev)

    c_total = int(candidates.shape[0])
    chunk = chunk or default_chunk(c_total, n, free0.shape[1])
    pad_c = max(((c_total + chunk - 1) // chunk) * chunk, chunk)
    cand_pad = torch.cat([candidates.to(i32),
                          torch.zeros((pad_c - c_total,), dtype=i32, device=dev)])

    outs = []
    for c0 in range(0, pad_c, chunk):
        c = cand_pad[c0:c0 + chunk]                                   # [C]
        cn = c.shape[0]
        slots = pad_order[starts[c].long()[:, None] + window[None, :]]  # [C, MPN]
        safe = slots.clamp(min=0).long()
        on_c = ((slots >= 0) & (scheduled.node_idx[safe] == c[:, None])
                & scheduled.valid[safe])
        movable = on_c & scheduled.movable[safe]
        blocker = (on_c & scheduled.blocks[safe]).any(dim=1)

        # --- compact this node's movable pods into K group slots ---
        gref = torch.where(movable, scheduled.group_ref[safe], g_total)  # sentinel
        counts = torch.zeros((cn, g_total + 1), dtype=i32, device=dev)
        counts.scatter_add_(1, gref.long(), movable.to(i32))
        nz = counts[:, :g_total] > 0                                   # [C, G]
        rank = torch.cumsum(nz, dim=1) - 1
        compact_of_g = torch.where(nz & (rank < kk), rank, kk)          # [C, G]
        # only the sentinel slot kk can repeat in this scatter, and it is
        # sliced away, so the unspecified order of repeated writes is harmless
        gidx = torch.zeros((cn, kk + 1), dtype=i32, device=dev)
        gidx.scatter_(1, compact_of_g, group_ids.expand(cn, g_total))
        gidx = gidx[:, :kk].long()                                     # [C, K]
        filled = slot_k[None, :] < nz.sum(dim=1).clamp(max=kk)[:, None]
        cnt_k = torch.where(filled, torch.gather(counts[:, :g_total], 1, gidx), 0)

        dest = dest_ok[None, :] & (node_ids[None, :] != c[:, None])    # [C, N]

        # --- K-step first-fit of whole groups onto destinations ---
        free_c = free0.expand(cn, n, free0.shape[1])
        placed_k, cumplace_k = [], []
        for j in range(kk):
            gi = gidx[:, j]
            want = cnt_k[:, j]
            reqg = specs.req[gi]                                       # [C, R]
            fit = fit_count(free_c, reqg)                              # [C, N]
            fit = torch.where(feas_gn[gi] & dest, fit, 0)
            fit = torch.where(limit_g[gi][:, None], fit.clamp(max=1), fit)
            fit = torch.minimum(fit, want[:, None])
            cum = torch.cumsum(fit, dim=1)
            place = torch.minimum((want[:, None] - (cum - fit)).clamp(min=0), fit)
            place = place.to(i32)
            free_c = free_c - place[:, :, None] * reqg[:, None, :]
            placed_k.append(place.sum(dim=1))
            cumplace_k.append(torch.cumsum(place, dim=1))
        placed_k = torch.stack(placed_k, dim=1)                        # [C, K]
        n_moved = placed_k.sum(dim=1).to(i32)
        n_failed = (movable.sum(dim=1) - n_moved).to(i32)
        drainable = ~blocker & (n_failed == 0)

        # --- per-pod destinations from the placement curves ---
        same = (gref[:, :, None] == gref[:, None, :]) \
            & movable[:, :, None] & movable[:, None, :]
        before = torch.tril(same, -1).sum(dim=2)                       # [C, MPN]
        j_of_slot = torch.gather(
            torch.cat([compact_of_g,
                       torch.full((cn, 1), kk, dtype=compact_of_g.dtype,
                                  device=dev)], dim=1),
            1, gref.long())
        dests = torch.full((cn, mpn), -1, dtype=i32, device=dev)
        for j in range(kk):
            d_j = torch.searchsorted(cumplace_k[j], before + 1).to(i32)
            hit = movable & (j_of_slot == j) & (before < placed_k[:, j][:, None])
            dests = torch.where(hit, d_j, dests)
        pod_slot = torch.where(on_c, safe.to(i32), -1)
        outs.append((drainable, blocker, n_moved, n_failed, dests, pod_slot))

    drainable, blocker, n_moved, n_failed, dests, pod_slot = (
        torch.cat(parts)[:c_total] for parts in zip(*outs))
    return RemovalResult(
        drainable=drainable,
        has_blocker=blocker,
        n_moved=n_moved,
        n_failed=n_failed,
        dest_node=dests,
        pod_slot=pod_slot,
        feas=feas_gn,
    )

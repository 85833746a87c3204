"""Expander scoring: every strategy's inputs as reductions over the options.

Counterpart of the reference package's `ops/scoring.py` (OptionScores,
fetch_scores, score_options, best_option).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    NodeGroupTensors,
    _Tree,
)
from kubernetes_autoscaler_tpu_torch.models.resources import CPU, MEMORY
from kubernetes_autoscaler_tpu_torch.ops.binpack import EstimateResult

_INF = 3.0e38

# helped_req is a float32 matrix product. On the card PyTorch would be free
# to run float32 products in TF32 (three decimal digits); the reference
# computes in full float32, so both TF32 switches are turned off here.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class OptionScores(_Tree):
    valid: torch.Tensor   # bool[NG] option schedules ≥1 pod with ≥1 node
    pods: torch.Tensor    # i32[NG] pods helped (most-pods maximizes)
    nodes: torch.Tensor   # i32[NG] new nodes (least-nodes minimizes)
    waste: torch.Tensor   # f32[NG] leftover cpu+mem fraction (least-waste)
    price: torch.Tensor   # f32[NG] node_count × price_per_node
    helped_req: torch.Tensor | None = None  # f32[NG, R] Σ_g scheduled × req


def fetch_scores(sc: OptionScores, phases=None) -> OptionScores:
    """Device→host in at most three copies (ops/hostfetch) — the host
    consumes these values element-wise, and each scalar read would be its
    own round trip. `phases` turns on the byte counters."""
    from kubernetes_autoscaler_tpu_torch.ops.hostfetch import fetch_pytree

    return fetch_pytree(sc, phases=phases)


def score_options(est: EstimateResult, groups: NodeGroupTensors,
                  specs=None) -> OptionScores:
    pods = est.scheduled.sum(dim=-1, dtype=torch.int32)
    nodes = est.node_count
    valid = groups.valid & (nodes > 0) & (pods > 0)
    helped_req = None
    if specs is not None:
        helped_req = (est.scheduled.to(torch.float32)
                      @ specs.req.to(torch.float32))          # [NG, R]

    used = (est.pods_per_node > 0).to(torch.float32)             # f32[NG, M]
    cap_cpu = groups.cap[:, CPU].to(torch.float32)
    cap_mem = groups.cap[:, MEMORY].to(torch.float32)
    total_cpu = used.sum(-1) * cap_cpu
    total_mem = used.sum(-1) * cap_mem
    free_cpu = (est.free_after[:, :, CPU].to(torch.float32) * used).sum(-1)
    free_mem = (est.free_after[:, :, MEMORY].to(torch.float32) * used).sum(-1)
    waste = torch.where(total_cpu > 0,
                        free_cpu / torch.clamp(total_cpu, min=1.0), 1.0)
    waste = waste + torch.where(total_mem > 0,
                                free_mem / torch.clamp(total_mem, min=1.0), 1.0)

    price = nodes.to(torch.float32) * groups.price_per_node
    return OptionScores(valid=valid, pods=pods, nodes=nodes, waste=waste,
                        price=price, helped_req=helped_req)


def best_option(scores: OptionScores,
                strategy: str = "least-waste") -> torch.Tensor:
    """i32 scalar: index of the winning node group (-1 if no valid option).
    Ties go to the lowest index. "random" is the deterministic stand-in of
    the reference: the first valid option."""
    if strategy == "most-pods":
        key = -scores.pods.to(torch.float32)
    elif strategy == "least-nodes":
        key = scores.nodes.to(torch.float32)
    elif strategy == "price":
        key = scores.price
    elif strategy in ("least-waste", "waste"):
        key = scores.waste
    elif strategy == "random":
        key = torch.zeros_like(scores.waste)
    else:
        raise ValueError(f"unknown expander strategy {strategy!r}")
    key = torch.where(scores.valid, key, _INF)
    idx = torch.argmin(key).to(torch.int32)
    return torch.where(scores.valid.any(), idx, -1)

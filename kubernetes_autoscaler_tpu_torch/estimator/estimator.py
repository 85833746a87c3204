"""Estimator: scale-up sizing behind the reference's EstimatorBuilder seam.

Reference counterpart: estimator/estimator.go:53-75 — `Estimate(pods,
nodeTemplate, nodeGroup) → (nodeCount, scheduledPods)`, with "binpacking" the
only registered implementation (BinpackingNodeEstimator,
binpacking_estimator.go:102). This module keeps that per-node-group call shape
for drop-in parity; the orchestrator prefers the batched all-groups kernel
(ops/binpack.estimate_all) and only falls back here when a processor injects a
custom estimator.

The port's copy: the limiter vectors are torch tensors on the group
tensors' device, and the estimate runs the port's unconstrained,
single-device `estimate_all` (the planes/nodes/constraint/mesh context is
kept for callers but not passed on: the control loop refuses constrained
worlds and meshes before it gets here).

Threshold limiters mirror estimator/threshold_based_limiter.go and friends:
a static cap (--max-nodes-per-scaleup), cluster-capacity and per-group caps,
composed as min().
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol

import numpy as np
import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    Dims,
    NodeGroupTensors,
    PodGroupTensors,
)
from kubernetes_autoscaler_tpu_torch.ops.binpack import EstimateResult, estimate_all


class EstimationLimiter(Protocol):
    """reference: estimator/estimation_limiter — node-count cap per estimation.

    Limiters may additionally implement `max_nodes_vec(cluster_size,
    max_new)` returning an i32[NG] tensor on max_new's device; the batched estimator path
    composes those without any per-group host arithmetic. Limiters without
    it fall back to a per-group `max_nodes` loop (one host fetch)."""

    def max_nodes(self, cluster_size: int, group_max_new: int) -> int: ...


@dataclass
class StaticThresholdLimiter:
    """reference: estimator/static_threshold.go (--max-nodes-per-scaleup)."""

    max_nodes_per_scaleup: int = 1000

    def max_nodes(self, cluster_size: int, group_max_new: int) -> int:
        return self.max_nodes_per_scaleup

    def max_nodes_vec(self, cluster_size: int, max_new) -> torch.Tensor:
        return torch.full_like(max_new, self.max_nodes_per_scaleup)


@dataclass
class ClusterCapacityThresholdLimiter:
    """reference: estimator/cluster_capacity_threshold.go (--max-nodes-total)."""

    max_nodes_total: int = 0

    def max_nodes(self, cluster_size: int, group_max_new: int) -> int:
        if self.max_nodes_total <= 0:
            return 1 << 30
        return max(self.max_nodes_total - cluster_size, 0)

    def max_nodes_vec(self, cluster_size: int, max_new) -> torch.Tensor:
        cap = (1 << 30) if self.max_nodes_total <= 0 \
            else max(self.max_nodes_total - cluster_size, 0)
        return torch.full_like(max_new, cap)


@dataclass
class SngCapacityThresholdLimiter:
    """reference: estimator/sng_capacity_threshold.go (maxSize - targetSize)."""

    def max_nodes(self, cluster_size: int, group_max_new: int) -> int:
        return max(group_max_new, 0)

    def max_nodes_vec(self, cluster_size: int, max_new) -> torch.Tensor:
        return torch.clamp(max_new, min=0)


def combined_limit(limiters: list[EstimationLimiter], cluster_size: int,
                   group_max_new: int) -> int:
    """reference: thresholdBasedEstimationLimiter composes via min."""
    return min(l.max_nodes(cluster_size, group_max_new) for l in limiters)


def combined_limit_vec(limiters: list[EstimationLimiter], cluster_size: int,
                       max_new) -> torch.Tensor:
    """Vectorized min-composition over all groups at once: the whole limiter
    stack stays on device for built-in limiters — no per-group host loop on
    the estimate path. A processor-injected limiter without `max_nodes_vec`
    degrades to one bounded host loop for that limiter only."""
    cap = torch.full_like(max_new, 1 << 30)
    for lim in limiters:
        vec = getattr(lim, "max_nodes_vec", None)
        if vec is not None:
            cap = torch.minimum(cap, vec(cluster_size, max_new))
        else:
            host = np.asarray(
                [min(lim.max_nodes(cluster_size, int(m)), 1 << 30)
                 for m in max_new.tolist()], np.int32)
            cap = torch.minimum(cap, torch.from_numpy(host).to(max_new.device))
    return cap


class BinpackingEstimator:
    """Per-node-group Estimate() parity wrapper over the batched kernel."""

    def __init__(self, dims: Dims, max_new_nodes_static: int = 1024,
                 limiters: list[EstimationLimiter] | None = None,
                 planes=None, nodes=None, with_constraints: bool = False,
                 mesh=None):
        self.dims = dims
        self.max_new_nodes_static = max_new_nodes_static
        self.limiters = limiters or [StaticThresholdLimiter()]
        # topology-coupled constraint context (ops/constrained.py): the real
        # cluster's resident planes + node tensors, threaded into estimate_all
        self.planes = planes
        self.nodes = nodes
        self.with_constraints = with_constraints
        # optional device mesh: NG options sharded over PODS_AXIS
        self.mesh = mesh

    def estimate(
        self,
        specs: PodGroupTensors,
        group_tensors: NodeGroupTensors,
        group_index: int,
        cluster_size: int = 0,
    ) -> tuple[int, np.ndarray]:
        """(node_count, scheduled[G]) for one node group — the reference
        Estimate() signature (estimator.go:63)."""
        limit = combined_limit(
            self.limiters, cluster_size,
            int(group_tensors.max_new[group_index]),
        )
        max_new = group_tensors.max_new.clone()
        max_new[group_index] = min(int(max_new[group_index]), limit)
        capped = group_tensors.replace(max_new=max_new)
        result = estimate_all(specs, capped, self.dims,
                              self.max_new_nodes_static)
        return (int(result.node_count[group_index]),
                result.scheduled[group_index].cpu().numpy())

    def estimate_all_groups(
        self,
        specs: PodGroupTensors,
        group_tensors: NodeGroupTensors,
        cluster_size: int = 0,
    ) -> EstimateResult:
        """The batched path the orchestrator actually uses: every group's
        option in one device program, with per-group caps applied — the
        limiter stack composes vectorized (combined_limit_vec), so no
        per-group host arithmetic sits on the loop path."""
        capped = group_tensors.replace(
            max_new=torch.minimum(
                group_tensors.max_new,
                combined_limit_vec(self.limiters, cluster_size,
                                   group_tensors.max_new))
        )
        return estimate_all(specs, capped, self.dims,
                            self.max_new_nodes_static)


def explain_refused_groups(
    specs: PodGroupTensors,
    group_tensors: NodeGroupTensors,
    refused: np.ndarray,         # bool[G] — groups no expansion option helped
    dims: Dims,
) -> np.ndarray:
    """The estimator layer's reason pass: uint16[G, NG] refusal bits for the
    refused pod groups against every node group's template (fresh empty
    node — capacity vs template allocatable, predicates vs template
    labels/taints). The reference reports this per pod from the estimator's
    scheduling errors ("pod didn't fit on node group …"); here it is ONE
    lazy masked dispatch + one batched fetch over refused groups only, so a
    loop where every option helps performs zero extra dispatches
    (`reason_extraction_dispatches` — the caller counts)."""
    from kubernetes_autoscaler_tpu_torch.ops import predicates as preds

    tmpl_nodes = group_tensors.as_node_tensors(dims)
    mask = torch.from_numpy(np.asarray(refused, bool).copy()).to(
        specs.req.device)
    return preds.reason_mask_for_groups(
        tmpl_nodes, specs, mask).cpu().numpy()


def build_estimator(name: str, dims: Dims, **kw) -> BinpackingEstimator:
    """reference: estimator.NewEstimatorBuilder (estimator.go:75)."""
    if name != "binpacking":
        raise ValueError(f"unknown estimator {name!r} (only 'binpacking' exists, "
                         "mirroring the reference)")
    return BinpackingEstimator(dims, **kw)

"""Tensorized cluster state as frozen dataclasses of torch tensors.

Counterpart of the reference package's `models/cluster_state.py`: the same
fields, shapes and dtypes (i32 / bool / f32), with `flax.struct` replaced by
frozen dataclasses that carry a `replace()` method. String-world constraints
are int32 hash slots (utils/hashing.fold32), padded with 0.

`from_numpy` carries state across from any object whose fields are numpy
arrays (for example the reference's trees after `np.asarray`), which is how
the tests feed both packages the same inputs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Dims:
    """Static padding dims (shape bucket)."""

    max_labels: int = 64       # label-hash slots per node (2 per label: pair + key)
    max_taints: int = 6        # taint slots per node
    max_tolerations: int = 8   # toleration slots per pod group
    max_sel_terms: int = 6     # ANDed selector requirements per pod group
    max_sel_alts: int = 4      # OR alternatives inside one requirement (In v1..vk)
    max_neg_terms: int = 4     # NotIn/DoesNotExist hashes per pod group
    max_pod_ports: int = 4     # hostPorts per pod group
    max_node_ports: int = 16   # occupied hostPort slots per node
    max_aff_terms: int = 2     # (anti-)affinity terms per pod group
    max_zones: int = 16        # topology-zone slots (id 0 = "no zone")


DEFAULT_DIMS = Dims()


class _Tree:
    """`replace()` for the frozen tensor dataclasses below."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class NodeTensors(_Tree):
    """Dense per-node state, leading dim N (padded; `valid` masks real rows)."""

    cap: torch.Tensor           # i32[N, R] allocatable
    alloc: torch.Tensor         # i32[N, R] requested by resident pods
    label_hash: torch.Tensor    # i32[N, L] fold32("k=v") and fold32(key-marker)
    taint_exact: torch.Tensor   # i32[N, T] fold32(key\0value\0effect)
    taint_key: torch.Tensor     # i32[N, T] fold32(key\0effect)
    used_ports: torch.Tensor    # i32[N, NP] fold32("port/proto") occupied
    zone_id: torch.Tensor       # i32[N] topology zone index (0 = unknown)
    group_id: torch.Tensor      # i32[N] node-group index (-1 = none)
    ready: torch.Tensor         # bool[N]
    schedulable: torch.Tensor   # bool[N]
    valid: torch.Tensor         # bool[N]

    @property
    def n(self) -> int:
        return self.cap.shape[0]

    def free(self) -> torch.Tensor:
        return self.cap - self.alloc


@dataclass(frozen=True)
class PodGroupTensors(_Tree):
    """Pending-pod equivalence groups, leading dim G."""

    req: torch.Tensor           # i32[G, R]
    count: torch.Tensor         # i32[G] pods in the group
    sel_req: torch.Tensor       # i32[G, S, A] ANDed requirements, each an OR over alts
    sel_neg: torch.Tensor       # i32[G, Sn] hashes that must be absent
    tol_exact: torch.Tensor     # i32[G, Tl]
    tol_key: torch.Tensor       # i32[G, Tl]
    tolerate_all: torch.Tensor  # bool[G]
    port_hash: torch.Tensor     # i32[G, PP]
    anti_affinity_self: torch.Tensor  # bool[G] self-anti-affinity on hostname
    valid: torch.Tensor         # bool[G]
    needs_host_check: torch.Tensor  # bool[G] encoding was lossy
    # Topology-coupled constraints; None = unconstrained. Kinds: 0 = none,
    # 1 = hostname-domain, 2 = zone-domain.
    spread_kind: torch.Tensor | None = None    # i32[G]
    max_skew: torch.Tensor | None = None       # i32[G]
    spread_self: torch.Tensor | None = None    # bool[G]
    aff_kind: torch.Tensor | None = None       # i32[G]
    aff_self: torch.Tensor | None = None       # bool[G]
    aff_match_any: torch.Tensor | None = None  # bool[G]
    anti_self_zone: torch.Tensor | None = None  # bool[G]

    @property
    def g(self) -> int:
        return self.req.shape[0]

    def one_per_node(self) -> torch.Tensor:
        """bool[G]: at most one pod of the group per node (hostname
        self-anti-affinity, or hostPorts that siblings would collide on)."""
        return self.anti_affinity_self | (self.port_hash != 0).any(dim=-1)


@dataclass(frozen=True)
class ScheduledPodTensors(_Tree):
    """Per-pod state of pods already placed on nodes (drain path)."""

    req: torch.Tensor        # i32[Ps, R]
    node_idx: torch.Tensor   # i32[Ps] current node (-1 = none)
    group_ref: torch.Tensor  # i32[Ps] row of PodGroupTensors for predicate data
    movable: torch.Tensor    # bool[Ps] evictable, must be rescheduled
    blocks: torch.Tensor     # bool[Ps] forbids draining its node
    valid: torch.Tensor      # bool[Ps]

    @property
    def p(self) -> int:
        return self.req.shape[0]


@dataclass(frozen=True)
class NodeGroupTensors(_Tree):
    """Per-node-group scale-up template + limits, leading dim NG."""

    cap: torch.Tensor            # i32[NG, R]
    label_hash: torch.Tensor     # i32[NG, L]
    taint_exact: torch.Tensor    # i32[NG, T]
    taint_key: torch.Tensor      # i32[NG, T]
    zone_id: torch.Tensor        # i32[NG]
    max_new: torch.Tensor        # i32[NG] nodes this group may still add
    price_per_node: torch.Tensor  # f32[NG] (0 = unknown)
    valid: torch.Tensor          # bool[NG]

    @property
    def ng(self) -> int:
        return self.cap.shape[0]

    def as_node_tensors(self, dims: Dims) -> NodeTensors:
        """View each template as a fresh, empty node row (predicate reuse)."""
        ng, r = self.cap.shape
        dev = self.cap.device
        return NodeTensors(
            cap=self.cap,
            alloc=torch.zeros((ng, r), dtype=torch.int32, device=dev),
            label_hash=self.label_hash,
            taint_exact=self.taint_exact,
            taint_key=self.taint_key,
            used_ports=torch.zeros((ng, dims.max_node_ports), dtype=torch.int32,
                                   device=dev),
            zone_id=self.zone_id,
            group_id=torch.arange(ng, dtype=torch.int32, device=dev),
            ready=torch.ones((ng,), dtype=torch.bool, device=dev),
            schedulable=torch.ones((ng,), dtype=torch.bool, device=dev),
            valid=self.valid,
        )


@dataclass(frozen=True)
class AffinityPlanes(_Tree):
    """Resident-derived counts for the topology-coupled constraints (built by
    the encoder; not read by the unconstrained path)."""

    aff_cnt: torch.Tensor        # i32[G, N]
    anti_host_cnt: torch.Tensor  # i32[G, N]
    anti_zone_cnt: torch.Tensor  # i32[G, N]
    spread_cnt: torch.Tensor     # i32[G, N]


@dataclass(frozen=True)
class ClusterTensors(_Tree):
    """The whole snapshot as one value."""

    nodes: NodeTensors
    pending: PodGroupTensors
    scheduled: ScheduledPodTensors
    groups: NodeGroupTensors
    planes: AffinityPlanes | None = None


def pad_to(n: int, bucket: int = 64) -> int:
    """Round up to a shape bucket."""
    if n <= 0:
        return bucket
    return ((n + bucket - 1) // bucket) * bucket


_TREES = {cls.__name__: cls for cls in (
    NodeTensors, PodGroupTensors, ScheduledPodTensors, NodeGroupTensors,
    AffinityPlanes, ClusterTensors)}


def _tree_class(name: str):
    """The port's tree class called `name`, or None. WavefrontPlan lives in
    ops/pack (which imports this module), so it is looked up here lazily."""
    if name == "WavefrontPlan":
        from kubernetes_autoscaler_tpu_torch.ops.pack import WavefrontPlan

        return WavefrontPlan
    return _TREES.get(name)


def from_numpy(obj, device: str | torch.device | None = None):
    """The port's dataclass of the same name as `obj`'s class, with every
    numpy field turned into a tensor on `device` (None = CUDA).

    `obj` is any object with the fields of one of the tensor trees above,
    or of a wavefront plan (ops/pack.WavefrontPlan), whose leaves are numpy
    arrays (or array-likes); nested trees convert recursively, None fields
    stay None and integer fields (a plan's `n_waves`, `n_active`) stay
    integers. Values are copied bit for bit: dtypes and shapes are those of
    the arrays."""
    from kubernetes_autoscaler_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    cls = _tree_class(type(obj).__name__)
    if cls is None:
        raise TypeError(f"no tensor tree named {type(obj).__name__!r}")
    out = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name, None)
        if v is None:
            out[f.name] = None
        elif isinstance(v, (int, np.integer)) and not isinstance(v, bool):
            out[f.name] = int(v)
        elif _tree_class(type(v).__name__) is not None:
            out[f.name] = from_numpy(v, dev)
        else:
            out[f.name] = torch.from_numpy(np.array(v, copy=True)).to(dev)
    return cls(**out)

"""TensorClusterSnapshot: the ClusterSnapshot contract on immutable pytrees.

Reference counterpart: simulator/clustersnapshot/clustersnapshot.go:43-105 —
the five mutating/query verbs plus Fork/Commit/Revert — implemented there by
the DeltaSnapshotStore's layered deltas (store/delta.go:33-54, an O(1)-fork
design motivated by Go pointer graphs). Here the whole cluster is one
immutable pytree, so:

  Fork   = push a reference onto a stack        (O(1), no copy)
  Revert = pop                                   (O(1))
  Commit = collapse the top into its parent      (O(1) pointer swap)

The entire delta-store complexity disappears by construction (SURVEY.md §7
step 3). Mutation verbs return *new* tensors (out-of-place `index_copy`,
never an in-place write): a fork shares its parent's tensors, and the
control loop's speculation gate compares tensors by identity.

The port's copy of the reference package's simulator/snapshot.py, for the
unconstrained single-device ops the port has.

Verbs are batch-first (whole equivalence groups / candidate sets per call) —
the serial per-pod verbs exist for parity and for the sidecar wire protocol,
implemented as batch calls of size 1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kubernetes_autoscaler_tpu_torch.models.api import Node, Pod
from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    NodeTensors,
    PodGroupTensors,
    ScheduledPodTensors,
)
from kubernetes_autoscaler_tpu_torch.models.encode import (
    EncodedCluster,
    encode_cluster,
    encode_node_row,
)


@dataclass
class _State:
    nodes: NodeTensors
    specs: PodGroupTensors
    scheduled: ScheduledPodTensors
    node_names: list[str]
    node_index: dict[str, int]
    n_valid: int
    planes: object = None   # AffinityPlanes | None — per-fork so growth
                            # padding cannot leak across revert


class SnapshotError(Exception):
    pass


class TensorClusterSnapshot:
    """Forkable cluster snapshot over device tensors."""

    def __init__(self, enc: EncodedCluster):
        self.enc = enc
        self._stack: list[_State] = [
            _State(
                nodes=enc.nodes,
                specs=enc.specs,
                scheduled=enc.scheduled,
                node_names=list(enc.node_names),
                node_index=dict(enc.node_index),
                n_valid=len(enc.node_names),
                planes=enc.planes,
            )
        ]

    # ---- construction ----

    @classmethod
    def from_objects(cls, nodes: list[Node], pods: list[Pod], **encode_kw):
        return cls(encode_cluster(nodes, pods, **encode_kw))

    # ---- fork/commit/revert (reference clustersnapshot.go:43-105) ----

    @property
    def state(self) -> _State:
        return self._stack[-1]

    def fork(self) -> None:
        s = self.state
        self._stack.append(
            _State(s.nodes, s.specs, s.scheduled, list(s.node_names),
                   dict(s.node_index), s.n_valid, s.planes)
        )

    def revert(self) -> None:
        if len(self._stack) == 1:
            raise SnapshotError("revert without fork")
        self._stack.pop()

    def commit(self) -> None:
        if len(self._stack) == 1:
            raise SnapshotError("commit without fork")
        top = self._stack.pop()
        self._stack[-1] = top

    def with_forked(self, fn):
        """reference: WithForkedSnapshot (clustersnapshot.go:135) — run fn on a
        fork; commit when it returns True, revert otherwise or on error."""
        self.fork()
        try:
            keep = fn()
        except Exception:
            self.revert()
            raise
        if keep:
            self.commit()
        else:
            self.revert()
        return keep

    # ---- node mutation (reference AddNodeInfo/RemoveNodeInfo) ----

    def add_node(self, node: Node, group_id: int = -1,
                 alloc_row=None) -> int:
        """Add a (template-instantiated) node; grows padded space if needed.
        Reference analog: estimator adding template nodes
        (binpacking_estimator.go:330 via SanitizedNodeInfo). `alloc_row`
        pre-charges the fresh node (DaemonSet overhead — the reference's
        template NodeInfos carry their DS pods, node_info_utils.go:45)."""
        s = self.state
        if node.name in s.node_index:
            raise SnapshotError(f"node {node.name} already in snapshot")
        i = s.n_valid
        if i >= s.nodes.n:
            s.nodes = _grow_nodes(s.nodes)
            if s.planes is not None:
                # constraint planes are [G, N]: keep the node axis in step
                # (new columns are zero — fresh nodes carry no residents);
                # per-FORK so a reverted growth cannot leak wider planes
                s.planes = s.planes.replace(**{
                    f: torch.nn.functional.pad(
                        getattr(s.planes, f), (0, getattr(s.planes, f).shape[1]))
                    for f in ("aff_cnt", "anti_host_cnt", "anti_zone_cnt",
                              "spread_cnt")})
        row = encode_node_row(node, self.enc.registry, self.enc.zone_table, self.enc.dims)
        nt = s.nodes
        s.nodes = nt.replace(
            cap=_set_row(nt.cap, i, row["cap"]),
            alloc=_set_row(nt.alloc, i,
                           0 if alloc_row is None else alloc_row),
            label_hash=_set_row(nt.label_hash, i, row["label_hash"]),
            taint_exact=_set_row(nt.taint_exact, i, row["taint_exact"]),
            taint_key=_set_row(nt.taint_key, i, row["taint_key"]),
            used_ports=_set_row(nt.used_ports, i, 0),
            zone_id=_set_row(nt.zone_id, i, row["zone_id"]),
            group_id=_set_row(nt.group_id, i, group_id),
            ready=_set_row(nt.ready, i, bool(row["ready"])),
            schedulable=_set_row(nt.schedulable, i, bool(row["schedulable"])),
            valid=_set_row(nt.valid, i, True),
        )
        s.node_names.append(node.name)
        s.node_index[node.name] = i
        s.n_valid += 1
        return i

    def remove_node(self, name: str) -> None:
        s = self.state
        if name not in s.node_index:
            raise SnapshotError(f"node {name} not in snapshot")
        i = s.node_index[name]
        s.nodes = s.nodes.replace(valid=_set_row(s.nodes.valid, i, False))
        # names keep their slots; index drops the mapping (ghost row)
        del s.node_index[name]

    def set_unschedulable(self, name: str, unschedulable: bool = True) -> None:
        s = self.state
        i = s.node_index[name]
        s.nodes = s.nodes.replace(
            schedulable=_set_row(s.nodes.schedulable, i, not unschedulable)
        )

    # ---- batch verbs (delegate to ops/) ----

    def schedule_pending_on_existing(self):
        from kubernetes_autoscaler_tpu_torch.ops.schedule import schedule_pending_on_existing

        s = self.state
        return schedule_pending_on_existing(s.nodes, s.specs, s.scheduled)

    def apply_placement(self, placed: torch.Tensor) -> None:
        """Charge a PackResult.placed (i32[G, N]) onto node allocations and
        decrement pending counts — the batch SchedulePod. The charge
        sum_g placed[g, n] * req[g, r] has no integer matmul on CUDA:
        broadcast, sum in int64 and narrow, wrapping as the reference's
        int32 einsum does (ops/autoscale_step.run_once_fused does the same)."""
        s = self.state
        add = (placed[:, :, None].to(torch.int64)
               * s.specs.req[:, None, :].to(torch.int64)).sum(dim=0).to(
            torch.int32)
        new_count = torch.clamp(s.specs.count - placed.sum(dim=1),
                                min=0).to(torch.int32)
        s.nodes = s.nodes.replace(alloc=s.nodes.alloc + add)
        s.specs = s.specs.replace(count=new_count)

    def check_predicates(self):
        from kubernetes_autoscaler_tpu_torch.ops.predicates import feasibility_mask

        s = self.state
        return feasibility_mask(s.nodes, s.specs)

    def simulate_removals(self, candidate_indices, dest_allowed=None,
                          max_pods_per_node: int = 128, chunk: int = 32):
        from kubernetes_autoscaler_tpu_torch.ops.drain import simulate_removals

        s = self.state
        dev = s.nodes.cap.device
        if dest_allowed is None:
            dest_allowed = torch.ones((s.nodes.n,), dtype=torch.bool,
                                      device=dev)
        return simulate_removals(
            s.nodes, s.specs, s.scheduled,
            torch.as_tensor(np.asarray(candidate_indices, np.int32),
                            device=dev),
            dest_allowed, max_pods_per_node=max_pods_per_node, chunk=chunk)


def _grow_nodes(nt: NodeTensors) -> NodeTensors:
    """Double the padded node capacity (rare; keeps shape buckets coarse)."""
    n = nt.n

    def pad(x, value=0):
        # n more rows of `value` on the leading axis
        return torch.cat([x, torch.full((n,) + tuple(x.shape[1:]), value,
                                        dtype=x.dtype, device=x.device)])

    grown = NodeTensors(
        cap=pad(nt.cap), alloc=pad(nt.alloc), label_hash=pad(nt.label_hash),
        taint_exact=pad(nt.taint_exact), taint_key=pad(nt.taint_key),
        used_ports=pad(nt.used_ports), zone_id=pad(nt.zone_id),
        group_id=pad(nt.group_id, -1),
        ready=pad(nt.ready), schedulable=pad(nt.schedulable), valid=pad(nt.valid),
    )
    return grown


def _set_row(t: torch.Tensor, i: int, value) -> torch.Tensor:
    """`t` with row `i` set to `value` (broadcast over the row), as a NEW
    tensor (the reference's `.at[i].set`)."""
    v = torch.as_tensor(np.asarray(value), device=t.device).to(t.dtype)
    v = v.expand(tuple(t.shape[1:])).reshape((1,) + tuple(t.shape[1:]))
    return t.index_copy(0, torch.tensor([i], device=t.device), v)

"""Drainability rules: classify every resident pod for scale-down.

Reference counterpart: simulator/drain.go:49-86 GetPodsToMove running the
ordered rule chain in simulator/drainability/rules/ (one subdir per rule:
mirror, longterminating, terminal, daemonset, safetoevict, notsafetoevict,
replicated, system, localstorage, pdb — rules.Default in rules/rules.go).

Verdicts map onto the tensor plane (ScheduledPodTensors):
  SKIP  — pod neither blocks nor needs rescheduling (mirror/daemonset/terminal:
          the kubelet or controller handles it; reference returns them in
          nothing-to-do lists)
  DRAIN — pod is evictable and must find a new home (movable=True)
  BLOCK — pod forbids removing its node (blocks=True)

PDB accounting is a separate tracker consulted at selection time, mirroring
the reference's RemainingPdbTracker split. A copy of the reference package's
simulator/drainability/rules.py; only the tensor write-back differs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from enum import Enum

from kubernetes_autoscaler_tpu_torch.models.api import SAFE_TO_EVICT_KEY, Pod

# reference: drainability/rules/longterminating uses an extended grace period
LONG_TERMINATING_THRESHOLD_S = 6 * 60.0


class Verdict(Enum):
    SKIP = "skip"
    DRAIN = "drain"
    BLOCK = "block"


@dataclass(frozen=True)
class DrainOptions:
    """Mirrors the drain-related AutoscalingOptions flags
    (config/autoscaling_options.go: SkipNodesWithSystemPods,
    SkipNodesWithLocalStorage, SkipNodesWithCustomControllerPods)."""

    skip_nodes_with_system_pods: bool = True
    skip_nodes_with_local_storage: bool = True
    skip_nodes_with_custom_controller_pods: bool = False
    # reference: rules/replicacount — a replicated pod whose controller runs
    # fewer than this many replicas blocks the drain (--min-replica-count)
    min_replica_count: int = 0

    # namespaces whose pods are "system" for the system rule
    system_namespace: str = "kube-system"


_REPLICATED_KINDS = {"ReplicaSet", "ReplicationController", "Job", "StatefulSet"}


def classify_pod(
    pod: Pod,
    opts: DrainOptions = DrainOptions(),
    now: float | None = None,
    has_pdb: bool = False,
    owner_replicas: int | None = None,
) -> Verdict:
    """Ordered rule chain; first decisive rule wins (reference rules.go order)."""
    now = time.time() if now is None else now

    # mirror (static kubelet pods): stay with the node, never block
    if pod.is_mirror():
        return Verdict.SKIP
    # long-terminating: already going away
    if pod.deletion_timestamp is not None and (
        now - pod.deletion_timestamp > LONG_TERMINATING_THRESHOLD_S
    ):
        return Verdict.SKIP
    # terminal: Succeeded/Failed never reschedule
    if pod.phase in ("Succeeded", "Failed"):
        return Verdict.SKIP
    # daemonset: the DS controller re-creates on remaining nodes; not our problem
    if pod.is_daemonset():
        return Verdict.SKIP

    safe = pod.annotations.get(SAFE_TO_EVICT_KEY)
    if safe == "false":
        return Verdict.BLOCK
    if safe == "true":
        return Verdict.DRAIN

    # replicated rule: a pod nobody would re-create blocks the drain
    controlled = pod.owner is not None and pod.owner.controller
    if not controlled:
        return Verdict.BLOCK
    if (
        pod.owner.kind not in _REPLICATED_KINDS
        and not opts.skip_nodes_with_custom_controller_pods
    ):
        # custom-controller pods block unless the operator opted out
        return Verdict.BLOCK

    # replicacount rule: a controller running below --min-replica-count
    # cannot spare a disruption (reference: rules/replicacount/rule.go —
    # desired replicas approximated by the controller's live pod count)
    if (opts.min_replica_count > 0 and owner_replicas is not None
            and owner_replicas < opts.min_replica_count):
        return Verdict.BLOCK

    # system rule: kube-system pods without a PDB block (reference: rules/system)
    if (
        opts.skip_nodes_with_system_pods
        and pod.namespace == opts.system_namespace
        and not has_pdb
    ):
        return Verdict.BLOCK

    # local storage rule
    if opts.skip_nodes_with_local_storage and pod.volumes_with_local_storage > 0:
        return Verdict.BLOCK

    return Verdict.DRAIN


def owner_replica_counts(*pod_lists) -> dict[str, int]:
    """Live pod count per controller uid (the observed stand-in for the
    controller's desired replicas, reference rules/replicacount)."""
    counts: dict[str, int] = {}
    for pods in pod_lists:
        for p in pods:
            if p is None or p.owner is None or p.phase in ("Succeeded",
                                                           "Failed"):
                continue
            counts[p.owner.uid] = counts.get(p.owner.uid, 0) + 1
    return counts


def apply_drainability(enc, opts: DrainOptions = DrainOptions(),
                       now: float | None = None, pdb_namespaced_names=frozenset()):
    """Populate ScheduledPodTensors.movable/blocks on an EncodedCluster in
    place, on the device of its tensors."""
    import numpy as np
    import torch

    movable = np.zeros((enc.scheduled.p,), bool)
    blocks = np.zeros((enc.scheduled.p,), bool)
    owner_counts = owner_replica_counts(
        enc.scheduled_pods, enc.pending_pods) \
        if opts.min_replica_count > 0 else {}
    for j, pod in enumerate(enc.scheduled_pods):
        v = classify_pod(
            pod, opts, now=now,
            has_pdb=f"{pod.namespace}/{pod.name}" in pdb_namespaced_names,
            owner_replicas=(owner_counts.get(pod.owner.uid)
                            if pod.owner is not None else None),
        )
        movable[j] = v is Verdict.DRAIN
        blocks[j] = v is Verdict.BLOCK
    dev = enc.scheduled.valid.device
    enc.scheduled = enc.scheduled.replace(
        movable=torch.as_tensor(movable, device=dev),
        blocks=torch.as_tensor(blocks, device=dev),
    )
    return enc

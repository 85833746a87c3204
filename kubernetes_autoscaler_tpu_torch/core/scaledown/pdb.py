"""PodDisruptionBudget tracking shared between scale-down planner and actuator.

Reference counterpart: core/scaledown/pdb/ (`RemainingPdbTracker`, basic impl)
— the planner asks whether a candidate node's pods can all be disrupted within
the remaining PDB budgets, and each confirmed removal deducts from those
budgets so two drains in the same loop never overdraw one PDB
(SURVEY.md §2.2 "Deletion tracker / latency tracker / PDB tracker" row).

The PDB object itself is a minimal structural analog of policy/v1
PodDisruptionBudget: a namespaced label selector plus the current
`status.disruptionsAllowed` count.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from kubernetes_autoscaler_tpu_torch.models.api import Pod


@dataclass
class PodDisruptionBudget:
    name: str
    namespace: str = "default"
    match_labels: dict[str, str] = field(default_factory=dict)
    disruptions_allowed: int = 0

    def matches(self, pod: Pod) -> bool:
        if pod.namespace != self.namespace:
            return False
        return all(pod.labels.get(k) == v for k, v in self.match_labels.items())


class RemainingPdbTracker:
    """reference: pdb.NewBasicRemainingPdbTracker — per-loop remaining budgets.

    `SetPdbs` resets at loop start (planner.go builds it from the PDB lister);
    `CanRemovePods` is the planner-side query; `RemovePods` is the deduction
    applied once a removal is confirmed.
    """

    def __init__(self, pdbs: list[PodDisruptionBudget] | None = None):
        self._pdbs: list[PodDisruptionBudget] = []
        self._remaining: list[int] = []
        # guards check+deduct: the actuator drains nodes from worker threads
        # and all of them share this tracker
        self._lock = threading.Lock()
        if pdbs:
            self.set_pdbs(pdbs)

    def set_pdbs(self, pdbs: list[PodDisruptionBudget]) -> None:
        with self._lock:
            self._pdbs = list(pdbs)
            self._remaining = [p.disruptions_allowed for p in pdbs]

    def get_pdbs(self) -> list[PodDisruptionBudget]:
        return list(self._pdbs)

    def remaining_snapshot(self) -> list[int]:
        """The LIVE remaining budgets (deductions by concurrent actuator
        drains included) — what any planning pass must gate against."""
        with self._lock:
            return list(self._remaining)

    def matching_pdbs(self, pod: Pod) -> list[int]:
        return [i for i, p in enumerate(self._pdbs) if p.matches(pod)]

    def has_pdb(self, pod: Pod) -> bool:
        return bool(self.matching_pdbs(pod))

    def reservation(self, pods: list[Pod]) -> dict[int, int]:
        """Per-PDB eviction counts `pods` would consume."""
        need: dict[int, int] = {}
        for pod in pods:
            for i in self.matching_pdbs(pod):
                need[i] = need.get(i, 0) + 1
        return need

    def can_remove_pods(self, pods: list[Pod],
                        already_reserved: dict[int, int] | None = None) -> bool:
        """True iff evicting all `pods` stays within every matching budget
        (reference: CanRemovePods returns inParallel + blocking pod info; the
        blocking detail surfaces via `first_blocker` for events).
        `already_reserved` lets a planning pass account for candidates it has
        confirmed earlier in the same loop without mutating the shared state."""
        need = self.reservation(pods)
        reserved = already_reserved or {}
        with self._lock:
            return all(
                self._remaining[i] - reserved.get(i, 0) >= n
                for i, n in need.items()
            )

    def try_remove_pods(self, pods: list[Pod]) -> bool:
        """Atomic check+deduct — the actuator's eviction-time gate. Returns
        False (and deducts nothing) if any budget would overdraw."""
        need = self.reservation(pods)
        with self._lock:
            if any(self._remaining[i] < n for i, n in need.items()):
                return False
            for i, n in need.items():
                self._remaining[i] -= n
            return True

    def first_blocker(self, pods: list[Pod]) -> Pod | None:
        need: dict[int, int] = {}
        for pod in pods:
            for i in self.matching_pdbs(pod):
                need[i] = need.get(i, 0) + 1
                if need[i] > self._remaining[i]:
                    return pod
        return None

    def remove_pods(self, pods: list[Pod]) -> None:
        need = self.reservation(pods)
        with self._lock:
            for i, n in need.items():
                self._remaining[i] -= n

    def remaining(self, pdb_name: str, namespace: str = "default") -> int:
        with self._lock:
            for i, p in enumerate(self._pdbs):
                if p.name == pdb_name and p.namespace == namespace:
                    return self._remaining[i]
        raise KeyError(f"{namespace}/{pdb_name}")

    def namespaced_names_with_pdb(self, pods: list[Pod]) -> frozenset[str]:
        """Feed for the drainability `system` rule (kube-system pods WITH a PDB
        are evictable; simulator/drainability/rules/system)."""
        return frozenset(
            f"{p.namespace}/{p.name}" for p in pods if self.has_pdb(p)
        )

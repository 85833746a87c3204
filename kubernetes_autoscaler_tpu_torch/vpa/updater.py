"""VPA updater: act on recommendations by evicting / in-place resizing pods.

Reference counterpart: vertical-pod-autoscaler/pkg/updater/logic/updater.go
(:159 RunOnce): find pods whose requests fall outside the recommendation's
[lower, upper] band (priority/update_priority_calculator.go), respect PDBs and
min-replicas, rate-limit evictions per replica set, evict (or in-place resize
when InPlaceOrRecreate and the kubelet supports it).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

from kubernetes_autoscaler_tpu_torch.vpa.model import UpdateMode, VerticalPodAutoscaler

# reference: priority/update_priority_calculator.go defaults
DEFAULT_SIGNIFICANT_CHANGE = 0.10     # 10% divergence triggers an update
POD_LIFETIME_MIN_S = 12 * 3600.0      # pods younger than this update only if outside bounds


@dataclass
class PodView:
    """What the updater needs to know about one pod."""

    name: str
    namespace: str
    owner_name: str
    containers: dict[str, dict[str, float]]   # container -> {cpu: cores, memory: bytes}
    start_time: float = 0.0
    replicas_of_owner: int = 1


@dataclass
class UpdateDecision:
    pod: PodView
    priority: float
    outside_bounds: bool
    in_place: bool = False


class Updater:
    def __init__(
        self,
        evict: Callable[[PodView], None],
        in_place_resize: Callable[[PodView, dict], bool] | None = None,
        eviction_rate_limit_per_loop: int = 10,
        can_evict: Callable[[PodView], bool] | None = None,
    ):
        self.evict = evict
        self.in_place_resize = in_place_resize
        self.eviction_rate_limit = eviction_rate_limit_per_loop
        # PDB gate (reference: eviction/pods_eviction_restriction.go — the
        # updater consults PodDisruptionBudgets before every eviction); the
        # callback owns the budget bookkeeping so repeated evictions of one
        # controller's pods draw down the same allowance.
        self.can_evict = can_evict

    def run_once(
        self,
        vpas: list[VerticalPodAutoscaler],
        pods: list[PodView],
        now: float | None = None,
    ) -> list[UpdateDecision]:
        now = time.time() if now is None else now
        decisions: list[UpdateDecision] = []
        by_target: dict[tuple, VerticalPodAutoscaler] = {
            (v.namespace, v.target_name): v for v in vpas
        }
        for pod in pods:
            vpa = by_target.get((pod.namespace, pod.owner_name))
            if vpa is None or vpa.update_mode in (UpdateMode.OFF, UpdateMode.INITIAL):
                continue
            if not vpa.recommendation:
                continue
            if pod.replicas_of_owner < vpa.min_replicas:
                continue  # reference: too few replicas to evict safely
            d = self._priority(pod, vpa, now)
            if d is not None:
                decisions.append(d)

        # highest priority first (reference: priority sorting)
        decisions.sort(key=lambda d: -d.priority)
        acted: list[UpdateDecision] = []
        budget = self.eviction_rate_limit
        for d in decisions:
            if budget <= 0:
                break
            if d.in_place and self.in_place_resize is not None:
                targets = {
                    r.container_name: r.target
                    for r in by_target[(d.pod.namespace, d.pod.owner_name)].recommendation
                }
                if self.in_place_resize(d.pod, targets):
                    acted.append(d)
                    continue  # no eviction needed
            if self.can_evict is not None and not self.can_evict(d.pod):
                continue  # PDB exhausted for this pod's controller
            self.evict(d.pod)
            acted.append(d)
            budget -= 1
        return acted

    def _priority(self, pod: PodView, vpa: VerticalPodAutoscaler,
                  now: float) -> UpdateDecision | None:
        """reference: update_priority_calculator.go — resource diff magnitude;
        pods outside [lower, upper] always update, in-band pods only when the
        change is significant and the pod is old enough."""
        outside = False
        total_diff = 0.0
        matched = False
        for rec in vpa.recommendation:
            current = pod.containers.get(rec.container_name)
            if current is None:
                continue
            matched = True
            for res in ("cpu", "memory"):
                cur = current.get(res, 0.0)
                tgt = rec.target.get(res, 0.0)
                lo = rec.lower_bound.get(res, 0.0)
                hi = rec.upper_bound.get(res, float("inf"))
                if cur < lo or cur > hi:
                    outside = True
                if cur > 0:
                    total_diff += abs(tgt - cur) / cur
        if not matched:
            return None
        significant = total_diff >= DEFAULT_SIGNIFICANT_CHANGE
        old_enough = now - pod.start_time >= POD_LIFETIME_MIN_S
        if not outside and not (significant and old_enough):
            return None
        in_place = vpa.update_mode is UpdateMode.IN_PLACE_OR_RECREATE
        return UpdateDecision(pod, total_diff + (10.0 if outside else 0.0),
                              outside, in_place)

"""Balancer: split a replica count across failure domains by policy.

Reference counterpart: balancer/ — the Balancer CRD
(pkg/apis/balancer.x-k8s.io/v1alpha1/types.go:46-63) and its controller
(pkg/controller), with `proportional` and `priority` policies
(pkg/policy/proportional.go, priority.go), per-domain min/max constraints and
fallback for domains with unschedulable pods.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TargetSpec:
    """One sub-deployment / failure domain."""

    name: str
    min_replicas: int = 0
    max_replicas: int = 1 << 30
    proportion: float = 0.0        # proportional policy weight
    priority: int = 0              # priority policy rank (higher first)


@dataclass
class BalancerSpec:
    name: str
    replicas: int
    policy: str = "proportional"   # proportional | priority
    targets: list[TargetSpec] = field(default_factory=list)
    fallback_on_problem: bool = True


def distribute(spec: BalancerSpec,
               problem_domains: set[str] = frozenset()) -> dict[str, int]:
    """Compute per-target replica counts (reference: policy.BalancePlacement)."""
    targets = spec.targets
    excluded: list[str] = []
    if spec.fallback_on_problem and problem_domains:
        healthy = [t for t in targets if t.name not in problem_domains]
        if healthy:
            excluded = [t.name for t in targets if t.name in problem_domains]
            targets = healthy

    # Excluded domains are explicitly zeroed (not dropped) so reconcile()
    # scales the unhealthy domain DOWN instead of leaving stale replicas
    # running alongside the rebalanced ones.
    alloc = {name: 0 for name in excluded}
    alloc.update({t.name: t.min_replicas for t in targets})
    remaining = spec.replicas - sum(alloc.values())
    if remaining < 0:
        # mins exceed replicas: trim from lowest-priority / lowest-weight tail
        order = sorted(targets, key=lambda t: (t.priority, t.proportion))
        for t in order:
            give_back = min(alloc[t.name], -remaining)
            alloc[t.name] -= give_back
            remaining += give_back
            if remaining >= 0:
                break
        return alloc

    if spec.policy == "priority":
        for t in sorted(targets, key=lambda t: -t.priority):
            take = min(remaining, t.max_replicas - alloc[t.name])
            alloc[t.name] += take
            remaining -= take
            if remaining == 0:
                break
    else:  # proportional (largest-remainder method, capped by max)
        weights = {t.name: max(t.proportion, 0.0) for t in targets}
        total_w = sum(weights.values()) or float(len(targets))
        if sum(weights.values()) == 0:
            weights = {t.name: 1.0 for t in targets}
        shares = {n: remaining * w / total_w for n, w in weights.items()}
        floors = {n: int(s) for n, s in shares.items()}
        caps = {t.name: t.max_replicas for t in targets}
        for t in targets:
            take = min(floors[t.name], caps[t.name] - alloc[t.name])
            alloc[t.name] += take
            remaining -= take
        # distribute remainders by largest fractional part, then overflow
        frac_order = sorted(targets, key=lambda t: -(shares[t.name] - floors[t.name]))
        i = 0
        while remaining > 0 and i < 10_000:
            progressed = False
            for t in frac_order:
                if remaining == 0:
                    break
                if alloc[t.name] < caps[t.name]:
                    alloc[t.name] += 1
                    remaining -= 1
                    progressed = True
            if not progressed:
                break
            i += 1
    return alloc


class BalancerController:
    """Reconcile loop: read spec + domain health, write per-target replicas
    (reference: balancer/pkg/controller/controller.go)."""

    def __init__(self, set_replicas):
        self.set_replicas = set_replicas   # (target_name, count) -> None

    def reconcile(self, spec: BalancerSpec,
                  problem_domains: set[str] = frozenset()) -> dict[str, int]:
        placement = distribute(spec, problem_domains)
        for name, count in placement.items():
            self.set_replicas(name, count)
        return placement

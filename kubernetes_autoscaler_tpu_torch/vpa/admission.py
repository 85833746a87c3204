"""VPA admission logic: patch pod requests to the current recommendation.

Reference counterpart: vertical-pod-autoscaler/pkg/admission-controller/ —
a mutating webhook (logic/server.go) that, on pod create, applies the matching
VPA's recommendation to container requests (resource/pod/patch) and proportionally
adjusts limits. The webhook transport (TLS server) is deployment plumbing; the
patch computation here is the product logic, exposed as a pure function plus an
optional HTTP server in sidecar/http.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from kubernetes_autoscaler_tpu_torch.vpa.model import UpdateMode, VerticalPodAutoscaler


@dataclass
class PatchOp:
    container: str
    resource: str
    value: float


def validate_vpa(vpa: VerticalPodAutoscaler) -> list[str]:
    """Validate a VPA object (reference: admission-controller also validates
    VPA create/update — vpa_lint: sane min<=max policy bounds, known modes,
    a target ref). Returns human-readable problems; empty means valid."""
    problems: list[str] = []
    if not vpa.target_name:
        problems.append("spec.targetRef is required")
    if vpa.min_replicas < 0:
        problems.append("minReplicas must be >= 0")
    for cp in vpa.resource_policies:
        if cp.mode not in ("Auto", "Off"):
            problems.append(
                f"container {cp.container_name!r}: unknown mode {cp.mode!r}")
        if cp.controlled_values not in ("RequestsOnly", "RequestsAndLimits"):
            problems.append(
                f"container {cp.container_name!r}: unknown controlledValues "
                f"{cp.controlled_values!r}")
        for res in set(cp.min_allowed) | set(cp.max_allowed):
            lo = cp.min_allowed.get(res)
            hi = cp.max_allowed.get(res)
            if lo is not None and lo < 0:
                problems.append(
                    f"container {cp.container_name!r}: minAllowed[{res}] < 0")
            if hi is not None and hi < 0:
                problems.append(
                    f"container {cp.container_name!r}: maxAllowed[{res}] < 0")
            if hi is not None and lo is not None and hi < lo:
                problems.append(
                    f"container {cp.container_name!r}: maxAllowed[{res}] < "
                    f"minAllowed[{res}]")
    return problems


def patch_for_pod(
    namespace: str,
    owner_name: str,
    containers: dict[str, dict[str, float]],     # container -> current requests
    limits: dict[str, dict[str, float]] | None,
    vpas: list[VerticalPodAutoscaler],
) -> list[PatchOp]:
    """Compute request patches for a pod being admitted."""
    vpa = next(
        (v for v in vpas
         if v.namespace == namespace and v.target_name == owner_name
         and v.update_mode is not UpdateMode.OFF),
        None,
    )
    if vpa is None or not vpa.recommendation:
        return []
    ops: list[PatchOp] = []
    for rec in vpa.recommendation:
        cur = containers.get(rec.container_name)
        if cur is None:
            continue
        policy = vpa.policy_for(rec.container_name)
        if policy.mode == "Off":
            continue
        for res, target in rec.target.items():
            current = cur.get(res, 0.0)
            if abs(current - target) < 1e-12:
                continue
            ops.append(PatchOp(rec.container_name, res, target))
            # proportional limit scaling (reference:
            # resource/pod/recommendation/...limit proportion logic)
            if limits and policy.controlled_values == "RequestsAndLimits":
                lim = limits.get(rec.container_name, {}).get(res)
                if lim is not None and current > 0:
                    ops.append(PatchOp(rec.container_name, f"limit:{res}",
                                       lim * target / current))
    return ops

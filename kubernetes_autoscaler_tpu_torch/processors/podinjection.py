"""Pod injection: pre-scale for pods controllers have not created yet.

Reference counterpart: processors/podinjection/ (SURVEY.md §2.6) — for each
Deployment/Job/ReplicaSet, compare desired replicas against the pods that
actually exist (scheduled or pending) and inject fake pending pods for the
gap, so scale-up provisions capacity before the workload controller finishes
creating its pods (useful for large Jobs rolling out faster than kubelet
registration).
"""

from __future__ import annotations

import copy

from kubernetes_autoscaler_tpu_torch.models.api import OwnerRef, Pod, Workload

FAKE_POD_ANNOTATION = "autoscaler.x-k8s.io/injected-pod"

_SUPPORTED_KINDS = {"Deployment", "ReplicaSet", "Job"}


def injected_pods_for(workload: Workload, existing: list[Pod]) -> list[Pod]:
    if workload.kind not in _SUPPORTED_KINDS or workload.template is None:
        return []
    owned = sum(
        1 for p in existing
        if p.owner is not None
        and (p.owner.uid == workload.uid
             or (p.owner.kind == workload.kind and p.owner.name == workload.name))
        and p.phase not in ("Succeeded", "Failed")
    )
    gap = workload.replicas - owned
    out = []
    for i in range(max(gap, 0)):
        p = copy.deepcopy(workload.template)
        p.name = f"injected-{workload.kind.lower()}-{workload.name}-{i}"
        p.namespace = workload.namespace
        p.node_name = ""
        p.phase = "Pending"
        p.annotations[FAKE_POD_ANNOTATION] = workload.name
        p.owner = OwnerRef(kind=workload.kind, name=workload.name,
                           uid=workload.uid)
        out.append(p)
    return out


class PodInjectionProcessor:
    """PodListProcessor appending the injection gap for every workload the
    source exposes (reference: podinjection processor in the default chain).

    `list_workloads` comes from the data source when it supports it (the
    FakeCluster does; a real deployment feeds Deployments/Jobs/ReplicaSets
    through the sidecar wire)."""

    def process(self, pods: list[Pod], ctx) -> list[Pod]:
        list_workloads = getattr(ctx, "list_workloads", None)
        if list_workloads is None:
            return pods
        # total injected fake pods per loop are capped (reference:
        # --pod-injection-limit, default 5000)
        limit = getattr(getattr(ctx, "options", None), "pod_injection_limit", 5000)
        out = list(pods)
        injected = 0
        for w in list_workloads():
            fakes = injected_pods_for(w, pods)
            if limit > 0 and injected + len(fakes) > limit:
                fakes = fakes[: max(limit - injected, 0)]
            out.extend(fakes)
            injected += len(fakes)
            if limit > 0 and injected >= limit:
                break
        return out

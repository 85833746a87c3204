"""Buffer controller: reconcile buffers and feed injection.

Reference counterpart: capacitybuffer/controller (wired by
InitializeAndRunDefaultBufferController, builder/autoscaler.go:209) — each
reconcile pass runs filters (strategy gate) → translators (resolve status) →
status updater. The autoscaler side then injects `pending_pods()` into every
loop's unschedulable list via BufferPodListProcessor.
"""

from __future__ import annotations

from kubernetes_autoscaler_tpu_torch.capacitybuffer.api import (
    ACTIVE_PROVISIONING_STRATEGY,
    READY_FOR_PROVISIONING,
    CapacityBuffer,
)
from kubernetes_autoscaler_tpu_torch.capacitybuffer.translators import (
    fake_pods_for,
    translate_buffer,
)
from kubernetes_autoscaler_tpu_torch.models.api import Pod


class BufferController:
    """Reconcile = filter chain → translate → quota clamp → status update.

    `status_sink(buffer)` is the persistence seam (the reference's updater/
    writes Status back through the CRD client); `headroom_quota` caps the
    TOTAL buffer headroom per resource (reference: controller/resourcequotas.go
    trimming buffers that would exceed the capacity quotas)."""

    def __init__(self, buffers: list[CapacityBuffer] | None = None,
                 filters=None, status_sink=None,
                 headroom_quota: dict[str, float] | None = None):
        from kubernetes_autoscaler_tpu_torch.capacitybuffer.filters import (
            default_filters,
        )

        self.buffers: list[CapacityBuffer] = list(buffers or [])
        self.filters = filters if filters is not None else default_filters()
        self.status_sink = status_sink
        self.headroom_quota = headroom_quota or {}

    def reconcile(self) -> list[CapacityBuffer]:
        """Returns the active set (reference: controller loop over
        filters/translators/updater)."""
        to_process = list(self.buffers)
        skipped: list[CapacityBuffer] = []
        for f in self.filters:
            to_process, skip = f.filter(to_process)
            skipped.extend(skip)
        for buf in to_process:
            translate_buffer(buf)
            buf.status.observed_generation = buf.generation
            buf.status.pod_template_generation = buf.pod_template_generation
            if self.status_sink is not None:
                try:
                    self.status_sink(buf)
                except Exception:
                    pass
        # generation-skipped buffers stay active if previously resolved ready
        active = [b for b in self.buffers if b.status.ready()]
        return [buf for buf, _ in self.active_with_replicas(active)]

    def active_with_replicas(self, active: list[CapacityBuffer] | None = None
                             ) -> list[tuple[CapacityBuffer, int]]:
        """(buffer, effective replicas) with the quota clamp applied
        TRANSIENTLY per reconcile — status.replicas keeps the spec-resolved
        value so the clamp relaxes the moment quota frees up (the clamp is a
        per-loop admission decision, not a spec mutation)."""
        if active is None:
            active = self.reconcile()
        if not self.headroom_quota:
            return [(b, b.status.replicas) for b in active]
        used: dict[str, float] = {}
        out: list[tuple[CapacityBuffer, int]] = []
        for buf in active:
            tmpl = buf.status.pod_template
            if tmpl is None:
                out.append((buf, buf.status.replicas))
                continue
            replicas = buf.status.replicas
            for res_name, limit in self.headroom_quota.items():
                per = float(tmpl.requests.get(res_name, 0.0))
                if per <= 0:
                    continue
                room = limit - used.get(res_name, 0.0)
                replicas = min(replicas, int(max(room, 0) // per))
            if replicas < buf.status.replicas:
                buf.status.conditions["reason"] = "LimitedByBufferQuota"
            else:
                buf.status.conditions.pop("reason", None)
            if replicas <= 0:
                continue
            for res_name in self.headroom_quota:
                used[res_name] = (used.get(res_name, 0.0)
                                  + float(tmpl.requests.get(res_name, 0.0))
                                  * replicas)
            out.append((buf, replicas))
        return out

    def pending_pods(self) -> list[Pod]:
        """Fake pending pods for all active buffers — injected each loop."""
        out: list[Pod] = []
        for buf, replicas in self.active_with_replicas():
            out.extend(fake_pods_for(buf, replicas=replicas))
        return out


class BufferPodListProcessor:
    """PodListProcessor injecting buffer headroom pods into the pending list
    (reference: the capacity-buffer injection step of the default pod-list
    chain; SURVEY.md §2.7 capacitybuffer row)."""

    def __init__(self, controller: BufferController):
        self.controller = controller

    def process(self, pods: list[Pod], ctx) -> list[Pod]:
        return pods + self.controller.pending_pods()

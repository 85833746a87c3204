"""Buffer filter chain.

Reference counterpart: capacitybuffer/filters/ — composable filters each
splitting the buffer list into (keep, skip): the provisioning-strategy filter
(strategy_filter.go), the status filter (status_filter.go: buffers whose
observed generation matches need no re-translation), and the pod-template
generation filter (podtemplate_generation_filter.go).
"""

from __future__ import annotations

from typing import Protocol

from kubernetes_autoscaler_tpu_torch.capacitybuffer.api import (
    ACTIVE_PROVISIONING_STRATEGY,
    READY_FOR_PROVISIONING,
    CapacityBuffer,
)


class BufferFilter(Protocol):
    def filter(self, buffers: list[CapacityBuffer]
               ) -> tuple[list[CapacityBuffer], list[CapacityBuffer]]:
        """(to_process, skipped)"""
        ...


class StrategyFilter:
    """Only the active provisioning strategy translates; foreign strategies
    park with an explanatory condition (reference: strategy filter)."""

    def filter(self, buffers):
        keep, skip = [], []
        for buf in buffers:
            if buf.provisioning_strategy == ACTIVE_PROVISIONING_STRATEGY:
                keep.append(buf)
            else:
                buf.status.conditions[READY_FOR_PROVISIONING] = "False"
                buf.status.conditions["reason"] = "UnsupportedProvisioningStrategy"
                skip.append(buf)
        return keep, skip


class GenerationFilter:
    """Buffers whose spec generation was already observed keep their resolved
    status untouched — translation is skipped (reference: status_filter +
    podtemplate_generation_filter; the CRD's ObservedGeneration contract)."""

    def filter(self, buffers):
        keep, skip = [], []
        for buf in buffers:
            if (buf.status.observed_generation == buf.generation
                    and buf.status.pod_template is not None):
                skip.append(buf)   # still active if previously ready
            else:
                keep.append(buf)
        return keep, skip


def default_filters() -> list[BufferFilter]:
    return [StrategyFilter(), GenerationFilter()]

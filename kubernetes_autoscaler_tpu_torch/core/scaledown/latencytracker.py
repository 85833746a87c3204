"""Node-removal latency tracking.

Reference counterpart: core/scaledown/latencytracker/ — measures the wall time
from a node first becoming a confirmed scale-down candidate (unneeded and past
its unneeded-time) to its deletion completing, feeding the
`scaled_down_duration` style metrics (SURVEY.md §2.2 trackers row).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class NodeLatencyTracker:
    started: dict[str, float] = field(default_factory=dict)
    observed: list[tuple[str, float]] = field(default_factory=list)

    def observe_candidates(self, nodes: list[str], now: float) -> None:
        """Start clocks for new candidates; stop clocks for nodes that left the
        candidate set without being deleted (they became needed again)."""
        current = set(nodes)
        for n in list(self.started):
            if n not in current:
                del self.started[n]
        for n in current:
            self.started.setdefault(n, now)

    def observe_deletion(self, node: str, now: float) -> float | None:
        t = self.started.pop(node, None)
        if t is None:
            return None
        latency = now - t
        self.observed.append((node, latency))
        from kubernetes_autoscaler_tpu_torch.metrics.metrics import default_registry

        default_registry.histogram("node_removal_latency_seconds").observe(latency)
        return latency

"""Usage-history providers: warm the recommender from stored metrics.

Reference counterpart: recommender/input/history/history_provider.go — on
startup the recommender optionally replays Prometheus range queries
(container_cpu_usage_seconds_total rate / container_memory_working_set_bytes)
into the aggregate histograms so recommendations have confidence from loop
one; otherwise history accrues only from live metrics-server samples.

The Prometheus REST transport is injected (`query_fn`) — this module owns
query construction and sample conversion, the caller owns IO. A canned
`query_fn` makes the whole path testable hermetically (and keeps this image
egress-free)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Protocol

from kubernetes_autoscaler_tpu_torch.vpa.model import ContainerUsageSample
from kubernetes_autoscaler_tpu_torch.vpa.recommender import Recommender

# series shape: {"metric": {label: value, ...}, "values": [[ts, "value"], ...]}
QueryFn = Callable[[str, float, float], list[dict]]

CPU_QUERY = ('rate(container_cpu_usage_seconds_total'
             '{job="kubernetes-cadvisor"}[%(rate)s])')
MEMORY_QUERY = 'container_memory_working_set_bytes{job="kubernetes-cadvisor"}'


class HistoryProvider(Protocol):
    def load_into(self, rec: Recommender, now: float) -> int:
        """Replay stored usage into the recommender; returns sample count."""
        ...


@dataclass
class PrometheusHistoryProvider:
    """Builds the reference's two range queries and feeds the results.

    `pod_owner` maps a pod name to its controlling workload (the reference
    resolves this through pod labels + the aggregation key grouping)."""

    query_fn: QueryFn
    pod_owner: Callable[[str, str], str]     # (namespace, pod name) -> owner
    history_length_s: float = 8 * 24 * 3600.0
    rate_window: str = "5m"

    def load_into(self, rec: Recommender, now: float) -> int:
        start = now - self.history_length_s
        samples: list[ContainerUsageSample] = []
        for query, resource in (
            (CPU_QUERY % {"rate": self.rate_window}, "cpu"),
            (MEMORY_QUERY, "memory"),
        ):
            for series in self.query_fn(query, start, now):
                labels = series.get("metric", {})
                ns = labels.get("namespace", "default")
                pod = labels.get("pod", labels.get("pod_name", ""))
                container = labels.get("container", labels.get("container_name", ""))
                if not pod or not container or container == "POD":
                    continue
                owner = self.pod_owner(ns, pod)
                for ts, val in series.get("values", []):
                    v = float(val)
                    samples.append(ContainerUsageSample(
                        namespace=ns, pod_name=pod, owner_name=owner,
                        container_name=container,
                        cpu_cores=v if resource == "cpu" else None,
                        memory_bytes=v if resource == "memory" else None,
                        timestamp=float(ts),
                    ))
        # One batched, age-weighted ingestion across ALL series and both
        # resources: exact w.r.t. per-timestamp sequential feeding, and a
        # single scatter-add per resource instead of a dispatch per sample.
        rec.feed_history(samples, now=now)
        return len(samples)

"""Debugging snapshot: on-demand JSON dump of the autoscaler's internal view.

Reference counterpart: cluster-autoscaler/debuggingsnapshot/ (SURVEY.md §2.7)
— the `/snapshotz` HTTP endpoint arms a snapshotter; during the next RunOnce
the loop feeds it node/pod state (static_autoscaler.go:299-300, 404, 527) and
the pending HTTP request receives the JSON once the loop completes.

Same protocol here: `request_snapshot()` arms it (returns a handle to await),
StaticAutoscaler calls the setters only when armed (`is_data_collection_
allowed`), and `flush()` resolves the handle.

A RunOnce that RAISES mid-loop must still resolve the handle — otherwise the
snapshotter stays armed forever and the `/snapshotz` caller hangs on a dead
loop. `flush(error=...)` ships whatever partial payload was collected plus
the error string. Every snapshot also carries the loop's observability keys:
`phaseStats` (metrics/phases.PhaseStats.snapshot() per owner) and `traceId`
(the flight-recorder trace covering this loop, metrics/trace.py) so the JSON
links directly to the Perfetto timeline that explains it.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any

from kubernetes_autoscaler_tpu_torch.models.api import Node, Pod


def _pod_view(p: Pod) -> dict[str, Any]:
    return {
        "name": p.name,
        "namespace": p.namespace,
        "requests": dict(p.requests),
        "nodeName": p.node_name,
        "phase": p.phase,
        "owner": p.owner.kind if p.owner else "",
        "priority": p.priority,
    }


def _node_view(n: Node, pods: list[Pod]) -> dict[str, Any]:
    return {
        "name": n.name,
        "ready": n.ready,
        "labels": dict(n.labels),
        "allocatable": dict(n.alloc_or_cap()),
        "taints": [vars(t) for t in n.taints],
        "pods": [_pod_view(p) for p in pods],
    }


class _Handle:
    def __init__(self):
        self.event = threading.Event()
        self.payload: str = ""

    def wait(self, timeout: float | None = None) -> str:
        self.event.wait(timeout)
        return self.payload


class DebuggingSnapshotter:
    """Armed/disarmed snapshot collector (reference:
    debugging_snapshotter.go DebuggingSnapshotterImpl state machine)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: _Handle | None = None
        self._data: dict[str, Any] = {}

    # ---- consumer side (the /snapshotz handler) ----

    def request_snapshot(self) -> _Handle:
        with self._lock:
            if self._armed is None:
                self._armed = _Handle()
                self._data = {}
            return self._armed

    # ---- producer side (RunOnce) ----

    def is_data_collection_allowed(self) -> bool:
        with self._lock:
            return self._armed is not None

    def set_cluster_nodes(self, nodes: list[Node], pods_by_node: dict[str, list[Pod]]) -> None:
        with self._lock:
            if self._armed is None:
                return
            self._data["nodeList"] = [
                _node_view(n, pods_by_node.get(n.name, [])) for n in nodes
            ]

    def set_unscheduled_pods_can_be_scheduled(self, pods: list[Pod]) -> None:
        with self._lock:
            if self._armed is None:
                return
            self._data["unscheduledPodsCanBeScheduled"] = [
                _pod_view(p) for p in pods
            ]

    def set_template_nodes(self, templates: dict[str, Node]) -> None:
        with self._lock:
            if self._armed is None:
                return
            self._data["templateNodes"] = {
                gid: _node_view(t, []) for gid, t in templates.items()
            }

    def set_errors(self, errors: list[str]) -> None:
        with self._lock:
            if self._armed is None:
                return
            self._data["errors"] = list(errors)

    def set_phase_stats(self, phases: dict[str, Any]) -> None:
        """Per-owner PhaseStats.snapshot() dicts for the serving loop."""
        with self._lock:
            if self._armed is None:
                return
            self._data["phaseStats"] = phases

    def set_trace_id(self, trace_id: str) -> None:
        with self._lock:
            if self._armed is None:
                return
            self._data["traceId"] = trace_id

    def set_journal_cursor(self, loop: int, digest: str) -> None:
        """The flight-journal cursor covering this loop (replay/journal.py)
        — the snapshot resolves to the exact record
        `python -m kubernetes_autoscaler_tpu_torch.replay` re-executes."""
        with self._lock:
            if self._armed is None:
                return
            self._data["journalLoop"] = int(loop)
            self._data["journalDigest"] = digest

    def set_reason_plane(self, payload: dict[str, Any]) -> None:
        """The loop's explainable verdicts: refused pod groups with their
        constraint bits, unremovable nodes with reasons + drain-failure
        detail, and the event-sink ring — so a /snapshotz dump of a breached
        loop says WHICH constraint refused WHICH pods."""
        with self._lock:
            if self._armed is None:
                return
            self._data["reasonPlane"] = payload

    def flush(self, now: float | None = None, error: str | None = None) -> None:
        """End of RunOnce: resolve the armed handle (reference: Flush).
        `error` is the flush-on-error path — the loop raised, so the caller
        gets the PARTIAL payload plus the error instead of hanging forever
        on a snapshotter nothing will ever flush again."""
        with self._lock:
            if self._armed is None:
                return
            if error is None and not self._data:
                # armed mid-loop AFTER this loop's collection points: stay
                # armed and serve the NEXT full loop instead of resolving
                # with an empty payload (error flushes always resolve — a
                # raised loop must never leave the caller hanging)
                return
            if error is not None:
                self._data["error"] = error
            self._data["timestamp"] = time.time() if now is None else now
            self._armed.payload = json.dumps(self._data, indent=2, default=str)
            self._armed.event.set()
            self._armed = None
            self._data = {}

"""Asynchronous node-group creation: the loop never blocks on the cloud.

Reference counterpart: core/scaleup/orchestrator/orchestrator.go:453
CreateNodeGroupAsync + async_initializer.go (applies the initial scale-up once
creation completes) + the AsyncNodeGroupStateChecker processor row (SURVEY.md
§2.6), which lets upcoming capacity from a still-creating group count toward
the snapshot so the next loops neither re-create the group nor re-scale for
the same pods.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from dataclasses import dataclass

from kubernetes_autoscaler_tpu_torch.cloudprovider.provider import NodeGroup
from kubernetes_autoscaler_tpu_torch.models.api import Node


@dataclass
class AsyncGroupState:
    group_id: str
    initial_delta: int      # scale-up to apply the moment creation completes
    template: Node
    started: float


class AsyncNodeGroupCreator:
    """Owns the background create → initial-scale-up pipeline and answers the
    AsyncNodeGroupStateChecker question: which groups are 'upcoming by
    creation' right now, and how much capacity was promised on them."""

    def __init__(self, cluster_state=None, max_workers: int = 4):
        self._lock = threading.Lock()
        self._states: dict[str, AsyncGroupState] = {}
        self._futures: list[concurrent.futures.Future] = []
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=max_workers)
        self.cluster_state = cluster_state
        self.errors: dict[str, str] = {}

    # ---- AsyncNodeGroupStateChecker surface ----

    def is_upcoming(self, group_id: str) -> bool:
        with self._lock:
            return group_id in self._states

    def upcoming(self) -> dict[str, AsyncGroupState]:
        """Snapshot of in-flight creations (group id → promised state)."""
        with self._lock:
            return dict(self._states)

    # ---- the async pipeline (reference: async_initializer.go) ----

    def create_async(self, group: NodeGroup, delta: int,
                     now: float | None = None) -> bool:
        """Start creating `group` and scale it to `delta` when ready. Returns
        False if a creation for this id is already in flight (idempotent)."""
        now = time.time() if now is None else now
        gid = group.id()
        with self._lock:
            if gid in self._states:
                return False
            self._states[gid] = AsyncGroupState(
                group_id=gid, initial_delta=delta,
                template=group.template_node_info(), started=now)
        self._futures.append(self._pool.submit(self._run, group, gid, delta))
        return True

    def _run(self, group: NodeGroup, gid: str, delta: int) -> None:
        try:
            created = group.create() if not group.exist() else group
            created.increase_size(delta)
            if self.cluster_state is not None:
                self.cluster_state.register_scale_up(created, delta, time.time())
        except Exception as e:  # noqa: BLE001 — ANY failure must be recorded:
            # an unexpected exception escaping into a never-inspected Future
            # would silently drop the promised capacity AND skip the backoff,
            # letting the broken group win the next loop again
            self.errors[gid] = f"{type(e).__name__}: {e}"
            if self.cluster_state is not None:
                try:
                    self.cluster_state.register_failed_scale_up(group, time.time())
                except Exception:
                    pass
        finally:
            with self._lock:
                self._states.pop(gid, None)

    def wait_idle(self, timeout: float = 30.0) -> None:
        """Drain in-flight creations (tests and shutdown)."""
        done, _ = concurrent.futures.wait(self._futures, timeout=timeout)
        self._futures = [f for f in self._futures if f not in done]

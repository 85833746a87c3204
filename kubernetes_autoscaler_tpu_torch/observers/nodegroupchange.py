"""Node-group change broadcast: cross-component scale event fan-out.

Reference counterpart: observers/nodegroupchange/ (SURVEY.md §2.7) — a
`ScaleStateNotifier` observer list the orchestrators/actuator call into on
every scale-up, scale-down, and failure; default subscribers update metrics
and the status document. Observers are plain callables here.
"""

from __future__ import annotations

from typing import Protocol


class NodeGroupChangeObserver(Protocol):
    def register_scale_up(self, group_id: str, delta: int, now: float) -> None: ...

    def register_scale_down(self, group_id: str, node_name: str, now: float) -> None: ...

    def register_failed_scale_up(self, group_id: str, reason: str, now: float) -> None: ...

    def register_failed_scale_down(self, group_id: str, node_name: str,
                                   reason: str, now: float) -> None: ...


class NodeGroupChangeObserverList:
    """Fan-out with isolation: one failing observer never blocks the rest
    (reference: nodegroupchange broadcaster iterates all registered)."""

    def __init__(self):
        self._observers: list[NodeGroupChangeObserver] = []

    def register(self, obs: NodeGroupChangeObserver) -> None:
        self._observers.append(obs)

    def _fan(self, method: str, *args) -> None:
        for o in self._observers:
            fn = getattr(o, method, None)
            if fn is None:
                continue
            try:
                fn(*args)
            except Exception:
                pass

    def register_scale_up(self, group_id: str, delta: int, now: float) -> None:
        self._fan("register_scale_up", group_id, delta, now)

    def register_scale_down(self, group_id: str, node_name: str, now: float) -> None:
        self._fan("register_scale_down", group_id, node_name, now)

    def register_failed_scale_up(self, group_id: str, reason: str, now: float) -> None:
        self._fan("register_failed_scale_up", group_id, reason, now)

    def register_failed_scale_down(self, group_id: str, node_name: str,
                                   reason: str, now: float) -> None:
        self._fan("register_failed_scale_down", group_id, node_name, reason, now)

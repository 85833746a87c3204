"""Unneeded-node time tracking for scale-down.

Reference counterpart: core/scaledown/unneeded/nodes.go (330 LoC) — per-node
"unneeded since" timestamps, compared against per-nodegroup
ScaleDownUnneededTime / ScaleDownUnreadyTime, reloadable from
DeletionCandidate taints after a restart (planner.go:91-93).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class UnneededNodes:
    since: dict[str, float] = field(default_factory=dict)

    def update(self, unneeded_now: list[str], now: float) -> None:
        """Keep timestamps for still-unneeded nodes; start clocks for new ones;
        drop nodes that became needed (reference: unneeded.Nodes.Update)."""
        current = set(unneeded_now)
        self.since = {n: t for n, t in self.since.items() if n in current}
        for n in current:
            self.since.setdefault(n, now)

    def removable_at(self, node: str, now: float, unneeded_time_s: float) -> bool:
        t = self.since.get(node)
        return t is not None and now - t >= unneeded_time_s

    def load_from_taints(self, tainted_since: dict[str, float]) -> None:
        """Crash recovery: resume clocks from DeletionCandidate taints
        (reference: LoadFromExistingTaints)."""
        for n, t in tainted_since.items():
            self.since.setdefault(n, t)

    def drop(self, node: str) -> None:
        self.since.pop(node, None)


@dataclass
class UnremovableNodes:
    """TTL cache of recently-unremovable nodes + reason (reference:
    core/scaledown/unremovable/, reasons enum simulator/cluster.go:63-103).

    Expired entries are swept eagerly on every `add`/`update` — not only on
    the `contains` read path — so the cache stays bounded by the live node
    set across loops even for nodes that are never probed again (a deleted
    node's entry would otherwise live forever)."""

    ttl_s: float = 5 * 60.0
    entries: dict[str, tuple[float, str]] = field(default_factory=dict)
    # next time add() owes a sweep — amortizes the full-dict rebuild so a
    # loop marking C nodes costs O(C), not O(C²) (update() sweeps eagerly
    # once per loop regardless)
    next_sweep: float = 0.0

    def sweep(self, now: float) -> None:
        """Drop every entry whose TTL elapsed (reference: unremovable.Nodes
        Update rebuilds the map from the still-valid entries each loop)."""
        self.entries = {n: e for n, e in self.entries.items() if e[0] >= now}
        self.next_sweep = now + self.ttl_s

    def update(self, now: float) -> None:
        """Per-loop maintenance hook (planner.update calls it once)."""
        self.sweep(now)

    def add(self, node: str, reason: str, now: float) -> None:
        if now >= self.next_sweep:
            self.sweep(now)
        self.entries[node] = (now + self.ttl_s, reason)

    def drop(self, node: str) -> None:
        """A verdict resolved (the node became drainable / was accepted for
        deletion): its refusal must leave every reason surface now, not at
        TTL expiry."""
        self.entries.pop(node, None)

    def contains(self, node: str, now: float) -> bool:
        e = self.entries.get(node)
        if e is None:
            return False
        if now > e[0]:
            del self.entries[node]
            return False
        return True

    def reason(self, node: str) -> str:
        e = self.entries.get(node)
        return e[1] if e else ""

    def reason_counts(self, now: float) -> dict[str, int]:
        """Per-reason histogram of the live entries — feeds the status
        document and the unremovable_nodes_count{reason=...} gauge family
        (reference: metrics.UpdateUnremovableNodesCount)."""
        self.sweep(now)
        counts: dict[str, int] = {}
        for _, reason in self.entries.values():
            counts[reason] = counts.get(reason, 0) + 1
        return counts

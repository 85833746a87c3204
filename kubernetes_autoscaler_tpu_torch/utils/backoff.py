"""Exponential per-node-group backoff after failed scale-ups.

Reference counterpart: utils/backoff/exponential_backoff.go (174 LoC) —
duration doubles per failure up to a cap, resets after a quiet period.

Memory: entries are pruned by an amortized sweep. An entry past its
`backoff_until` whose last failure is also older than `reset_timeout_s` can
never influence a future verdict (`is_backed_off` is False and the next
`backoff()` would start the ladder fresh), so it is garbage. The sweep runs
from `backoff()` whenever the dict crosses a watermark set to 2× the live
count after the previous sweep — O(1) amortized per call, and the dict stays
bounded by ~2× the number of groups that failed within the reset window,
instead of growing without bound under node-group churn on long runs
(autoprovisioned groups mint fresh ids forever).
"""

from __future__ import annotations

from dataclasses import dataclass, field

_SWEEP_FLOOR = 64


@dataclass
class _Entry:
    duration: float
    backoff_until: float
    last_failure: float


@dataclass
class ExponentialBackoff:
    initial_s: float = 300.0
    max_s: float = 1800.0
    reset_timeout_s: float = 3 * 3600.0
    _entries: dict[str, _Entry] = field(default_factory=dict)
    _sweep_watermark: int = _SWEEP_FLOOR

    def backoff(self, group_id: str, now: float) -> float:
        """Record a failure; returns the until-timestamp."""
        e = self._entries.get(group_id)
        if e is not None and now - e.last_failure < self.reset_timeout_s:
            duration = min(e.duration * 2, self.max_s)
        else:
            duration = self.initial_s
        self._entries[group_id] = _Entry(duration, now + duration, now)
        if len(self._entries) >= self._sweep_watermark:
            self.sweep(now)
        return now + duration

    def is_backed_off(self, group_id: str, now: float) -> bool:
        e = self._entries.get(group_id)
        return e is not None and now < e.backoff_until

    def remove_backoff(self, group_id: str) -> None:
        self._entries.pop(group_id, None)

    def sweep(self, now: float) -> None:
        """Drop entries that can no longer affect any verdict (backoff
        elapsed AND quiet past the reset window) and re-arm the watermark
        at 2× the surviving population."""
        self._entries = {
            g: e for g, e in self._entries.items()
            if now < e.backoff_until
            or now - e.last_failure < self.reset_timeout_s
        }
        self._sweep_watermark = max(_SWEEP_FLOOR, 2 * len(self._entries))

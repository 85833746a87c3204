"""Throttled, deduplicated autoscaling event sink — the reason plane's
human-facing surface.

Reference counterpart: the kube EventRecorder calls spread through the
autoscaler — per-pod NoScaleUp events with skip reasons
(core/scaleup/orchestrator posts "pod didn't trigger scale-up" with the
per-nodegroup reasons), per-node NoScaleDown/ScaleDownFailed events
(core/scaledown), all spam-bounded by the API server's event aggregation and
the klogx logging quotas (utils/klogx, hinting_simulator.go:57).

Here: one in-process sink shared by the scale-up orchestrator and the
scale-down planner. Emission is

  * deduplicated by (kind, object, reason) — a repeat inside the dedup
    window bumps the stored event's count instead of producing a new one
    (the reference gets this from kube event aggregation);
  * throttled per loop through a klogx.LoggingQuota — the first N distinct
    events per loop reach the log/store, the overflow is COUNTED (the
    `dropped` field rides bench.py's JSON so a reason-plane regression that
    floods events is visible in the perf trajectory) and summarized with the
    klogx "... and N more" frame;
  * bounded in memory by `capacity` (oldest evicted first).

Counters ride an attached metrics.Registry: `scale_events_total{kind,reason}`
and `scale_events_dropped_total`. Dedup-aggregated repeats ALSO increment
`scale_events_total` — the stored events' count aggregates and the counter
deltas describe the same stream (pinned by test), so lineage can trust
either. The stored ring is exported by `snapshot()` into `/snapshotz`
payloads so a flight-recorder investigation sees the same verdicts the
events carried, and `history(kind, obj)` serves the per-object view the
lineage join reads without scanning the whole ring.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

from kubernetes_autoscaler_tpu_torch.utils import klogx

NO_SCALE_UP = "NoScaleUp"
NO_SCALE_DOWN = "NoScaleDown"

_EVENTS_HELP = "Autoscaling reason events emitted, by kind and reason"
_DROPPED_HELP = "Reason events dropped by the per-loop klogx quota"


@dataclass
class Event:
    kind: str        # NoScaleUp | NoScaleDown
    obj: str         # pod (scale-up) or node (scale-down) name
    reason: str      # taxonomy string (ops/predicates.REASON_BITS names,
                     # or the reference unremovable enum values)
    message: str = ""
    count: int = 1
    first_ts: float = 0.0
    last_ts: float = 0.0

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "object": self.obj, "reason": self.reason,
            "message": self.message, "count": self.count,
            "firstTimestamp": self.first_ts, "lastTimestamp": self.last_ts,
        }


@dataclass
class EventSink:
    per_loop_quota: int = 20
    dedup_window_s: float = 600.0
    capacity: int = 512
    history_objects: int = 256          # (kind, obj) keys in the side index
    registry: object | None = None      # optional metrics.Registry
    events: "OrderedDict[tuple, Event]" = field(default_factory=OrderedDict)
    dropped: int = 0
    deduped: int = 0
    emitted: int = 0
    _quota: klogx.LoggingQuota = field(init=False)
    # (kind, obj) -> {reason: Event} — the same Event objects the ring
    # holds, so a dedup count bump is visible here for free; LRU-bounded
    # by key count, pruned when the ring evicts
    _by_obj: "OrderedDict[tuple, OrderedDict]" = field(init=False)

    def __post_init__(self):
        self._quota = klogx.LoggingQuota(self.per_loop_quota)
        self._by_obj = OrderedDict()

    # ---- loop framing (RunOnce calls both) ----

    def begin_loop(self) -> None:
        self._quota.reset()

    def end_loop(self) -> None:
        """Overflow summary + quota reset (klogx frame contract)."""
        klogx.frame_up(self._quota, "scale events")

    # ---- emission ----

    def emit(self, kind: str, obj: str, reason: str, message: str = "",
             now: float = 0.0) -> None:
        key = (kind, obj, reason)
        ev = self.events.get(key)
        if ev is not None and now - ev.last_ts <= self.dedup_window_s:
            # aggregation: same verdict again — count it, keep one event.
            # The counter still moves: the stored count aggregate and the
            # scale_events_total delta must describe the same stream.
            ev.count += 1
            ev.last_ts = now
            if message:
                ev.message = message
            self.deduped += 1
            self.events.move_to_end(key)
            if self.registry is not None:
                self.registry.counter("scale_events_total",
                                      help=_EVENTS_HELP).inc(kind=kind,
                                                             reason=reason)
            return
        klogx.v(self._quota, "%s %s: %s%s", kind, obj, reason,
                f" ({message})" if message else "")
        if self._quota.left < 0:
            # over the loop quota: counted, not stored (the klogx frame
            # prints the "... and N more" line at end_loop)
            self.dropped += 1
            if self.registry is not None:
                self.registry.counter("scale_events_dropped_total",
                                      help=_DROPPED_HELP).inc()
            return
        stored = Event(kind=kind, obj=obj, reason=reason,
                       message=message, first_ts=now, last_ts=now)
        self.events[key] = stored
        self.events.move_to_end(key)
        while len(self.events) > self.capacity:
            old_key, _ = self.events.popitem(last=False)
            self._unindex(old_key)
        self._index(key, stored)
        self.emitted += 1
        if self.registry is not None:
            self.registry.counter("scale_events_total",
                                  help=_EVENTS_HELP).inc(kind=kind,
                                                         reason=reason)

    # ---- per-object side index ----

    def _index(self, key: tuple, ev: Event) -> None:
        okey = (key[0], key[1])
        bucket = self._by_obj.get(okey)
        if bucket is None:
            bucket = OrderedDict()
            self._by_obj[okey] = bucket
            while len(self._by_obj) > self.history_objects:
                self._by_obj.popitem(last=False)
        bucket[key[2]] = ev
        self._by_obj.move_to_end(okey)

    def _unindex(self, key: tuple) -> None:
        okey = (key[0], key[1])
        bucket = self._by_obj.get(okey)
        if bucket is not None:
            bucket.pop(key[2], None)
            if not bucket:
                del self._by_obj[okey]

    def history(self, kind: str | None, obj: str) -> list[dict]:
        """The bounded per-object view lineage joins at query time — O(its
        own reasons), never O(ring). kind=None merges both kinds for the
        object name (lineage's node kind sees NoScaleDown; pod-group sees
        NoScaleUp)."""
        keys = [(kind, obj)] if kind is not None else \
            [(NO_SCALE_UP, obj), (NO_SCALE_DOWN, obj)]
        out: list[dict] = []
        for okey in keys:
            bucket = self._by_obj.get(okey)
            if bucket:
                out.extend(ev.to_dict() for ev in bucket.values())
        out.sort(key=lambda d: d["lastTimestamp"])
        return out

    # ---- export ----

    def snapshot(self) -> list[dict]:
        """Newest-last list of stored events (rides /snapshotz payloads).

        Ordered by lastTimestamp on EXPORT, not by ring position: the ring
        orders by update sequence, but emitters stamp `now` from their own
        clock domains (planner loop time vs orchestrator wall time), so a
        dedup-aggregated event can hold a fresher timestamp than entries
        updated after it — exporting ring order interleaved stale and fresh
        reasons in /snapshotz event tails. The sort is stable, so equal
        timestamps keep their update order."""
        return [ev.to_dict() for ev in
                sorted(self.events.values(), key=lambda e: e.last_ts)]

    def find(self, kind: str | None = None, obj: str | None = None,
             reason: str | None = None) -> list[Event]:
        return [
            ev for ev in self.events.values()
            if (kind is None or ev.kind == kind)
            and (obj is None or ev.obj == obj)
            and (reason is None or ev.reason == reason)
        ]

"""Quota-limited logging: cap per-loop log spam from per-pod/per-node paths.

Reference counterpart: cluster-autoscaler/utils/klogx — a logging quota
(`klogx.NewLoggingQuota(N)`) consumed by hot loops (e.g.
hinting_simulator.go:57 logs the first N unschedulable pods, then one
"...and M more" summary). Same shape here over the stdlib logger.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("kubernetes_autoscaler_tpu")


class LoggingQuota:
    def __init__(self, limit: int):
        self.limit = limit
        self.left = limit

    def reset(self) -> None:
        self.left = self.limit


def v(quota: LoggingQuota, msg: str, *args, level: int = logging.INFO) -> None:
    """Log while the quota lasts; overflow is counted, not printed."""
    quota.left -= 1
    if quota.left >= 0:
        logger.log(level, msg, *args)


def frame_up(quota: LoggingQuota, what: str, level: int = logging.INFO) -> None:
    """Emit the '... and N more' summary and reset (reference: klogx.V(...).
    Over() + the summary line after the loop)."""
    if quota.left < 0:
        logger.log(level, "... and %d other %s", -quota.left, what)
    quota.reset()

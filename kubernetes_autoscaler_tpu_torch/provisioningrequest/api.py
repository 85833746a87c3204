"""ProvisioningRequest API: atomic capacity reservations.

Reference counterpart: cluster-autoscaler/apis/provisioningrequest/.../v1/
types.go:77-97 and provisioningrequest/ (SURVEY.md §2.7) — a request names a
provisioning class and a list of pod sets (template × count); the autoscaler
answers by either verifying capacity exists now (check-capacity) or scaling
up all-or-nothing (best-effort-atomic-scale-up), then books the capacity for
a TTL by injecting the request's pods into every loop until the booking
expires.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional

from kubernetes_autoscaler_tpu_torch.models.api import OwnerRef, Pod

# Supported classes (reference: provisioningrequest/supported_classes.go).
CHECK_CAPACITY_CLASS = "check-capacity.autoscaling.x-k8s.io"
BEST_EFFORT_ATOMIC_CLASS = "best-effort-atomic-scale-up.autoscaling.x-k8s.io"
SUPPORTED_CLASSES = (CHECK_CAPACITY_CLASS, BEST_EFFORT_ATOMIC_CLASS)

# Condition types (reference: v1 conditions).
PROVISIONED = "Provisioned"
FAILED = "Failed"
ACCEPTED = "Accepted"
BOOKING_EXPIRED = "BookingExpired"

# Booked capacity is held this long after Provisioned=True (reference:
# provreq booking expiry; checkcapacity pods injection window).
DEFAULT_BOOKING_TTL_S = 10 * 60.0

FAKE_POD_ANNOTATION = "autoscaler.x-k8s.io/provisioning-request-pod"


@dataclass
class PodSet:
    template: Pod
    count: int


@dataclass
class ProvisioningRequest:
    name: str
    namespace: str = "default"
    class_name: str = CHECK_CAPACITY_CLASS
    pod_sets: list[PodSet] = field(default_factory=list)
    conditions: dict[str, tuple[str, str]] = field(default_factory=dict)  # type -> (status, reason)
    creation_time: float = 0.0
    provisioned_time: Optional[float] = None
    booking_ttl_s: float = DEFAULT_BOOKING_TTL_S

    # ---- condition helpers (reference: provreqwrapper) ----

    def set_condition(self, cond: str, status: bool, reason: str = "",
                      now: float | None = None) -> None:
        self.conditions[cond] = ("True" if status else "False", reason)
        if cond == PROVISIONED and status and self.provisioned_time is None:
            self.provisioned_time = now

    def has(self, cond: str) -> bool:
        return self.conditions.get(cond, ("False", ""))[0] == "True"

    def terminal(self) -> bool:
        return self.has(FAILED) or self.has(BOOKING_EXPIRED)

    def booked(self, now: float) -> bool:
        """Capacity is held: Provisioned and the booking TTL has not lapsed."""
        if not self.has(PROVISIONED) or self.terminal():
            return False
        if self.provisioned_time is None:
            return True
        return now - self.provisioned_time < self.booking_ttl_s

    def expire_booking(self, now: float) -> bool:
        """Flip to BookingExpired once the TTL lapses (reference: the provreq
        processor marking BookingExpired); returns True when flipped."""
        if self.has(PROVISIONED) and not self.terminal() \
                and self.provisioned_time is not None \
                and now - self.provisioned_time >= self.booking_ttl_s:
            self.set_condition(BOOKING_EXPIRED, True, "BookingTTLLapsed")
            return True
        return False

    def total_pods(self) -> int:
        return sum(ps.count for ps in self.pod_sets)

    def pods(self) -> list[Pod]:
        """Materialize the request's pods (reference: provreqwrapper builds
        fake pods per pod set for injection/simulation).

        Cached per pod-set identity: booked requests re-inject every loop,
        and stable object identity lets the incremental encoder skip
        re-lowering them (a ProvisioningRequest whose spec changes is a new
        object in the k8s model, so identity-keying is sound)."""
        # key holds the TEMPLATE REFERENCES (not bare ids): retaining them
        # both prevents id reuse after GC and makes identity comparison sound
        key = tuple((ps.template, ps.count) for ps in self.pod_sets)
        cached = getattr(self, "_pods_cache", None)
        if cached is not None and len(cached[0]) == len(key) and all(
                a[0] is b[0] and a[1] == b[1]
                for a, b in zip(cached[0], key)):
            return list(cached[1])
        out: list[Pod] = []
        for si, ps in enumerate(self.pod_sets):
            for i in range(ps.count):
                p = copy.deepcopy(ps.template)
                p.name = f"provreq-{self.name}-{si}-{i}"
                p.namespace = self.namespace
                p.node_name = ""
                p.phase = "Pending"
                p.annotations[FAKE_POD_ANNOTATION] = self.name
                p.owner = OwnerRef(kind="ProvisioningRequest", name=self.name,
                                   uid=f"provreq-{self.namespace}-{self.name}")
                out.append(p)
        self._pods_cache = (key, out)
        return list(out)

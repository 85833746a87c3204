"""Fixed resource-vector layout for the tensorized cluster state.

The reference models resources as a string→quantity map (k8s resource.Quantity,
consumed via the vendored scheduler's NodeResourcesFit plugin and CA's own
utilization math, cluster-autoscaler/simulator/utilization/info.go:50). The
tensor plane instead fixes a dense int32 vector of length NUM_RESOURCES per
node/pod (a copy of the reference package's models/resources.py):

  slot 0  cpu        (millicores;   reference uses milli-units throughout)
  slot 1  memory     (MiB)
  slot 2  ephemeral  (MiB)
  slot 3  pods       (count; every pod implicitly requests 1 — mirrors the
                      scheduler's v1.ResourcePods capacity check)
  slots 4..  extended resources (count), mapped by a per-snapshot registry
             (e.g. nvidia.com/gpu, google.com/tpu — reference GPU handling in
              cluster-autoscaler/utils/gpu/ and cloudprovider GpuConfig)

int32 + integer units keeps comparisons exact on the device (float rounding
could overcommit memory). Quantization is conservative: requests round
UP, capacities round DOWN, so the tensor plane never admits a pod the exact
(reference) check would reject.
"""

from __future__ import annotations

from dataclasses import dataclass, field

CPU, MEMORY, EPHEMERAL, PODS = 0, 1, 2, 3
NUM_STANDARD = 4
NUM_EXTENDED = 4          # default extended-resource slots
NUM_RESOURCES = NUM_STANDARD + NUM_EXTENDED

_MIB = 1024 * 1024


def cpu_request_to_milli(cores: float) -> int:
    """Requests round UP (conservative: simulated pod never under-requests)."""
    import math

    return math.ceil(cores * 1000 - 1e-9)


def cpu_capacity_to_milli(cores: float) -> int:
    """Capacities round DOWN (conservative: simulated node never over-offers)."""
    return int(cores * 1000 + 1e-9)


def mem_request_to_mib(bytes_: float) -> int:
    """Requests round UP (conservative: simulated pod never under-requests)."""
    return -(-int(bytes_) // _MIB)


def mem_capacity_to_mib(bytes_: float) -> int:
    """Capacities round DOWN (conservative: simulated node never over-offers)."""
    return int(bytes_) // _MIB


@dataclass
class ExtendedResourceRegistry:
    """Maps extended-resource names (e.g. 'nvidia.com/gpu') to tensor slots.

    Per-snapshot, first-come-first-served. Unknown resources beyond capacity
    raise — the encoder then marks the pod for host-side exact checking rather
    than silently dropping a constraint.
    """

    slots: dict[str, int] = field(default_factory=dict)
    capacity: int = NUM_EXTENDED

    def slot_for(self, name: str) -> int:
        if name in self.slots:
            return self.slots[name]
        if len(self.slots) >= self.capacity:
            raise KeyError(f"extended-resource slots exhausted; cannot map {name!r}")
        idx = NUM_STANDARD + len(self.slots)
        self.slots[name] = idx
        return idx

    def try_slot_for(self, name: str) -> int | None:
        """slot_for that reports exhaustion instead of raising; callers flag the
        pod/node for host-side exact checking (the documented lossy path)."""
        try:
            return self.slot_for(name)
        except KeyError:
            return None

    def known(self, name: str) -> bool:
        return name in self.slots

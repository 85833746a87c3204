"""Shape classes: the padded (nodes × groups × pods) ladder tenants bucket into.

Multi-tenant serving (docs/SERVING.md) batches many tenants' simulations into
one vmapped dispatch — which requires their worlds to share ONE padded tensor
shape, because a fresh shape is a fresh XLA program (~seconds of compile on
the serving path). This module owns that quantization: a small fixed ladder
of geometric rungs per axis, seeded from the same node/group/pod bucket
bases `models/incremental.py` uses for its delta-scatter padding, so the
sidecar's shape discipline matches the in-process encoder's.

A rung is `base * 2^k`, so the whole ladder for a 64-base axis serving up to
1M rows is 15 classes — new tenants land in an existing class with
probability ≈ 1, which is what makes the "≈0 recompiles for a new tenant"
guarantee (`recompiles_per_new_tenant` gauge, CI-asserted like
`steady_state_recompiles`) achievable at all.

Counters: `shape_class_hit_total` / `shape_class_miss_total` count
classifications against the set of classes already seen — a miss means a new
padded shape entered the ladder and the next dispatch at that shape will
compile. The hit RATE over a traffic window is the bench's
`shape_class_hit_rate` (1.0 after warmup, asserted in CI).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class ShapeClass:
    """One padded world shape: every tenant in the class exports tensors at
    exactly these leading dims (pad rows invalid-masked), so their worlds
    stack into one pytree and share one compiled batched program."""

    nodes: int
    groups: int
    pods: int

    @property
    def key(self) -> str:
        return f"n{self.nodes}g{self.groups}p{self.pods}"


def rung(n: int, base: int) -> int:
    """Smallest base*2^k ≥ n (n ≤ 0 → base). Geometric, unlike the linear
    `pad_to` multiples: a ladder of multiples would mint a distinct class
    per bucket increment and compile-store one program per tenant size."""
    if base <= 0:
        raise ValueError(f"rung base must be positive, got {base}")
    r = base
    while r < n:
        r *= 2
    return r


class ShapeLadder:
    """Classifier + seen-set + hit/miss accounting. Thread-safe: the gRPC
    pool classifies concurrently."""

    def __init__(self, node_bucket: int = 64, group_bucket: int = 64,
                 pod_bucket: int = 256, registry=None):
        self.node_bucket = node_bucket
        self.group_bucket = group_bucket
        self.pod_bucket = pod_bucket
        self._seen: set[ShapeClass] = set()
        self._lock = threading.Lock()
        self._registry = registry
        self.hits = 0
        self.misses = 0

    def classify(self, n_nodes: int, n_groups: int, n_pods: int,
                 tenant: str = "") -> ShapeClass:
        """Assign counts to a class and account the hit/miss. Counts within
        a rung re-classify to the SAME class — count churn (pods added or
        removed inside the rung) is always a hit, never a recompile, the
        same stability contract as the delta-scatter buckets.

        `tenant` additionally labels the registry series so a departed
        tenant's classification history can be stale-zeroed by
        `drop_tenant` (the rpc_total convention); the default tenant keeps
        label-free series (it is never dropped)."""
        sc = ShapeClass(
            nodes=rung(n_nodes, self.node_bucket),
            groups=rung(max(n_groups, 1), self.group_bucket),
            pods=rung(n_pods, self.pod_bucket),
        )
        with self._lock:
            hit = sc in self._seen
            if hit:
                self.hits += 1
            else:
                self._seen.add(sc)
                self.misses += 1
        if self._registry is not None:
            name = ("shape_class_hit_total" if hit
                    else "shape_class_miss_total")
            labels = {"shape_class": sc.key}
            if tenant:
                labels["tenant"] = tenant
            self._registry.counter(
                name,
                help="World classifications landing in an already-seen "
                     "(hit) vs a brand-new (miss) padded shape class — a "
                     "miss precedes exactly one batched-program compile",
            ).inc(**labels)
        return sc

    def seen(self) -> frozenset[ShapeClass]:
        with self._lock:
            return frozenset(self._seen)

    def hit_rate(self) -> float:
        with self._lock:
            total = self.hits + self.misses
            return (self.hits / total) if total else 1.0

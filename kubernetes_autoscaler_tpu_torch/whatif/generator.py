"""Seeded synthetic workload generator for rollouts — kwok-style scenario
traffic (SURVEY §5) as plain arrays.

A `WorkloadSpec` is a value object: (kind, seed, knobs) fully determines the
generated trace, byte for byte, forever — `generate_workload` uses a
dedicated `np.random.RandomState(seed)` and no ambient entropy. That makes
traces journal-recordable: the spec's `to_record()` dict rides a journal's
loop annotations or a what-if report, and replaying it through
`from_record` + `generate_workload` reproduces the exact trace the original
rollout consumed.

Patterns:
- `quiet`   — all zeros (the null workload; steady-state identity runs)
- `diurnal` — sinusoidal arrival rate around `base_rate` with `amplitude`,
              period `period_steps`, Poisson-sampled per (step, group)
- `bursty`  — quiet baseline + Bernoulli(`burst_prob`) bursts of
              `burst_size` pods landing on one random group
- `spot`    — diurnal arrivals + Bernoulli(`reclaim_prob`) per-step spot
              reclaims of `reclaim_nodes` random live nodes
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

KINDS = ("quiet", "diurnal", "bursty", "spot")


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    kind: str = "quiet"
    seed: int = 0
    base_rate: float = 2.0      # mean pod arrivals per step per group
    amplitude: float = 1.0      # diurnal swing as a fraction of base_rate
    period_steps: int = 24      # steps per diurnal cycle
    burst_prob: float = 0.1     # per-step burst probability (bursty)
    burst_size: int = 16        # pods per burst
    reclaim_prob: float = 0.05  # per-step spot-reclaim probability
    reclaim_nodes: int = 1      # nodes reclaimed per event

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown workload kind {self.kind!r}; "
                             f"one of {KINDS}")

    def to_record(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["v"] = 1
        return d

    @classmethod
    def from_record(cls, d: dict[str, Any]) -> "WorkloadSpec":
        d = {k: v for k, v in d.items() if k != "v"}
        return cls(**d)


def generate_workload(spec: WorkloadSpec, t_steps: int, n_groups: int,
                      n_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Returns (adds i32[T, G], fails bool[T, N]) for a rollout."""
    rng = np.random.RandomState(np.uint32(spec.seed))
    adds = np.zeros((t_steps, n_groups), np.int32)
    fails = np.zeros((t_steps, n_nodes), bool)
    if spec.kind == "quiet" or n_groups == 0:
        return adds, fails

    steps = np.arange(t_steps, dtype=np.float64)
    if spec.kind in ("diurnal", "spot"):
        period = max(spec.period_steps, 1)
        rate = spec.base_rate * (
            1.0 + spec.amplitude * np.sin(2.0 * np.pi * steps / period))
        rate = np.maximum(rate, 0.0)
        adds = rng.poisson(
            rate[:, None], size=(t_steps, n_groups)).astype(np.int32)
    if spec.kind == "bursty":
        hit = rng.random_sample(t_steps) < spec.burst_prob
        tgt = rng.randint(0, n_groups, size=t_steps)
        adds[hit, tgt[hit]] += np.int32(spec.burst_size)
    if spec.kind == "spot" and n_nodes > 0:
        hit = rng.random_sample(t_steps) < spec.reclaim_prob
        for t in np.nonzero(hit)[0]:
            victims = rng.choice(
                n_nodes, size=min(spec.reclaim_nodes, n_nodes),
                replace=False)
            fails[t, victims] = True
    return adds, fails


def lane_workloads(variants, adds: np.ndarray,
                   fails: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Fan one generated trace out to B lanes, applying each variant's
    `pending_scale`. Lanes with the default scale broadcast the trace
    bitwise untouched (the null lane's trace is THE trace)."""
    b = len(variants)
    adds_b = np.broadcast_to(adds[None], (b,) + adds.shape).copy()
    fails_b = np.broadcast_to(fails[None], (b,) + fails.shape).copy()
    for i, v in enumerate(variants):
        if v.pending_scale != 1.0:
            adds_b[i] = np.ceil(
                adds * np.float64(v.pending_scale)).astype(np.int32)
    return adds_b, fails_b

"""Seeded worlds for the topology-aware drain sweep (`drain_kernel.sweep`
with `TopoInputs`): the cases that `tests/test_torch_drain_topo.py` holds
byte-equal to the JAX package's `simulate_removals(...,
with_constraints=True)` on the CPU, and that `chip_smoke.py` and
`tests/test_torch_kernels_cuda.py` hold byte-equal to the plain version on
the card.

`CASES` maps each case's name to a function that returns a `Case` on the
CPU: drain_cases' random tensor world (capacities, requests, selectors,
flags; every node a candidate) with zones and topology constraints added.
All cases share one set of shapes (N = 48 nodes in zones 1-3 and a keyless
node every eighth, G = 12 groups, R = 4, P = 480 pod rows, a window of
MPN = 160 places, K = 4 slots, Z = 4 zones), so a reference compiles once
for all of them. The resident count planes are what an encoder would count:
each group's constraint has a target group, and a plane counts the valid
residents of its target on each node (the group itself for a self
constraint), so a candidate's own residents are in its zone's totals.

Every case has (candidate, slot) lanes whose group is constrained and has
pods: they re-place by waves. Each case pins what its name says: a
hostname spread, a self-counted zone spread, zone anti-affinity to the
group itself (anti_self_zone), host and zone affinity with the bootstrap
seed and to residents, a candidate whose removal frees its own zone (the
ghost node), limit_one beside a spread, a slot that the MAX_WAVES cap cuts
short, a constrained group past K, candidates with constrained and
unconstrained slots, negative free capacity, a mix of every kind, and
spreads and a limit_one group whose fit passes MPN on every node (the drain
kernel's fit plane caps it there).

`world` builds such a world at any widths (the card tests and
`chip_smoke.py` use it where every lane is active).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import AffinityPlanes
from kubernetes_autoscaler_tpu_torch.ops.kernels import drain_cases
from kubernetes_autoscaler_tpu_torch.ops.kernels.drain_cases import (
    _clear,
    _pods_on,
    _t,
    _world,
)

N, G, R, P, MPN, K, Z = 48, 12, 4, 480, 160, 4, 4
ZONE1_LABEL = 201   # the label every node of zone 1 carries in max_waves


@dataclass
class Case(drain_cases.Case):
    planes: AffinityPlanes | None = None
    max_zones: int = Z

    def to(self, device) -> "Case":
        base = drain_cases.Case.to(self, device)
        planes = AffinityPlanes(**{k: v.to(device)
                                   for k, v in vars(self.planes).items()})
        return Case(**vars(base), planes=planes, max_zones=self.max_zones)

    def inputs(self):
        """(SweepInputs, TopoInputs) of this world (ops/drain.topo_inputs,
        ops/drain.sweep_inputs)."""
        from kubernetes_autoscaler_tpu_torch.ops.drain import (
            sweep_inputs,
            topo_inputs,
        )

        topo, gate = topo_inputs(self.nodes, self.specs, self.planes,
                                 self.max_zones)
        return sweep_inputs(self.nodes, self.specs, self.scheduled,
                            self.candidates, self.dest_allowed,
                            self.max_pods_per_node, gate), topo


@dataclass
class _Topo:
    """A drain_cases world with zones and constraints, edited by the cases
    before `case()`. Targets are group indices (-1: no resident counts)."""

    w: drain_cases._World
    zone: np.ndarray           # i32[N] 0 = keyless, else 1..Z-1
    s_kind: np.ndarray         # i32[G]
    skew: np.ndarray
    s_self: np.ndarray
    a_kind: np.ndarray
    a_self: np.ndarray
    a_any: np.ndarray
    anti_zone_self: np.ndarray
    spread_of: np.ndarray      # i32[G] target group of each plane
    aff_of: np.ndarray
    anti_zone_of: np.ndarray
    anti_host_of: np.ndarray

    def counts(self, target: np.ndarray) -> np.ndarray:
        """i32[G, N]: valid residents of each group's target on each node."""
        w = self.w
        n, g = self.zone.shape[0], target.shape[0]
        out = np.zeros((g, n), np.int32)
        on = w.flags[0] & (w.node_idx >= 0)
        for k in range(g):
            if target[k] >= 0:
                rows = on & (w.group_ref == target[k])
                np.add.at(out[k], w.node_idx[rows], 1)
        return out

    def case(self) -> Case:
        base = self.w.case()
        i32, b8 = torch.int32, torch.bool
        nodes = type(base.nodes)(**{**vars(base.nodes),
                                    "zone_id": _t(self.zone, i32)})
        specs = type(base.specs)(**{
            **vars(base.specs),
            "spread_kind": _t(self.s_kind, i32), "max_skew": _t(self.skew, i32),
            "spread_self": _t(self.s_self, b8), "aff_kind": _t(self.a_kind, i32),
            "aff_self": _t(self.a_self, b8), "aff_match_any": _t(self.a_any, b8),
            "anti_self_zone": _t(self.anti_zone_self, b8)})
        planes = AffinityPlanes(
            aff_cnt=_t(self.counts(self.aff_of), i32),
            anti_host_cnt=_t(self.counts(self.anti_host_of), i32),
            anti_zone_cnt=_t(self.counts(self.anti_zone_of), i32),
            spread_cnt=_t(self.counts(self.spread_of), i32))
        return Case(nodes, specs, base.scheduled, base.candidates,
                    base.dest_allowed, base.max_pods_per_node,
                    base.max_groups_per_node, planes=planes, max_zones=Z)


def _topo(seed: int, n: int = N, g: int = G, r: int = R, p: int = P,
          mpn: int = MPN, kk: int = K, residents=(0, 4),
          load: float = 0.5) -> _Topo:
    """An unconstrained world: zones 1..3 round robin, every eighth node
    keyless; no group constrained; no hostPorts or self-anti-affinity (a
    case adds them)."""
    w = _world(seed, n=n, g=g, r=r, p=p, residents=residents, mpn=mpn,
               kk=kk, load=load)
    w.anti[:] = False
    w.ports[:] = 0
    zone = (1 + np.arange(n) % 3).astype(np.int32)
    zone[7::8] = 0
    none = np.full(g, -1, np.int32)
    return _Topo(w=w, zone=zone, s_kind=np.zeros(g, np.int32),
                 skew=np.ones(g, np.int32), s_self=np.zeros(g, bool),
                 a_kind=np.zeros(g, np.int32), a_self=np.zeros(g, bool),
                 a_any=np.zeros(g, bool), anti_zone_self=np.zeros(g, bool),
                 spread_of=none.copy(), aff_of=none.copy(),
                 anti_zone_of=none.copy(), anti_host_of=none.copy())


def _spread(t: _Topo, g: int, kind: int, skew: int = 1) -> None:
    """Group g spreads over hostnames (kind 1) or zones (kind 2), counting
    itself."""
    t.s_kind[g], t.skew[g], t.s_self[g], t.spread_of[g] = kind, skew, True, g


def _small(t: _Topo, g: int, req=(1, 0, 0, 0)) -> None:
    """Group g: a small request, no selector."""
    t.w.req[g] = req
    t.w.sel[g] = 0


def host_spread() -> Case:
    """Group 2 spreads over hostnames at skew 1: candidates 4 and 9 hold 6
    of its pods each."""
    t = _topo(101)
    _spread(t, 2, 1)
    _small(t, 2)
    for node in (4, 9):
        _pods_on(t.w, node, [2] * 6)
    return t.case()


def zone_spread_self() -> Case:
    """Group 3 spreads over zones at skew 1, counting itself; candidate 5
    holds 7 of its pods, candidate 6 three; residents elsewhere."""
    t = _topo(102)
    _spread(t, 3, 2)
    _small(t, 3)
    _pods_on(t.w, 5, [3] * 7)
    _pods_on(t.w, 6, [3] * 3)
    _pods_on(t.w, 12, [3, 3])
    return t.case()


def zone_anti_self() -> Case:
    """Group 4 allows one pod a zone (anti_self_zone): one resident each in
    zones 1 (node 0) and 2 (node 1), none in zone 3; node 10 (zone 2) holds
    two more."""
    t = _topo(103)
    t.anti_zone_self[4], t.anti_zone_of[4] = True, 4
    _small(t, 4)
    for node in (0, 1, 10):
        _clear(t.w, node)
    _pods_on(t.w, 0, [4])
    _pods_on(t.w, 1, [4])
    _pods_on(t.w, 10, [4, 4, 1])
    return t.case()


def affinity() -> Case:
    """Host self-affinity with no resident match (group 5: the bootstrap
    seed, then the nodes it opened), zone self-affinity likewise (group 8),
    zone affinity to group 7's residents (group 6; node 3, moved to zone 3,
    holds them all), host affinity to group 9's residents (group 10, on
    nodes 14 and 20)."""
    t = _topo(104)
    for g in (5, 6, 8, 10):
        _small(t, g)
    t.a_kind[5], t.a_self[5], t.aff_of[5] = 1, True, 5
    t.a_kind[8], t.a_self[8], t.aff_of[8] = 2, True, 8
    t.a_kind[6], t.aff_of[6] = 2, 7
    t.a_kind[10], t.aff_of[10] = 1, 9
    for g in (7, 9):                           # only where pinned
        t.w.group_ref[t.w.group_ref == g] = 1
    _pods_on(t.w, 3, [7, 7])
    t.zone[3] = 3
    _pods_on(t.w, 14, [9])
    _pods_on(t.w, 20, [9])
    for node, pods in ((2, [5] * 4 + [8] * 3 + [6] * 2 + [10] * 2),
                       (11, [5] * 3 + [8] * 4 + [6, 10])):
        _clear(t.w, node)
        _pods_on(t.w, node, pods)
    return t.case()


def ghost_node() -> Case:
    """Group 9 allows one pod a zone and has one in each zone (nodes 0, 1,
    2: zones 1, 2, 3); group 10 is zone-anti-affine to group 11, which has a
    resident in every zone, the one of zone 2 beside group 10's pod on node
    4. Keyless nodes take nothing: each of those pods can only return to its
    own zone, which the ghost node frees once the candidate is drained."""
    t = _topo(105)
    for g in (9, 10, 11):
        _small(t, g)
        t.w.group_ref[t.w.group_ref == g] = 0
    t.anti_zone_self[9], t.anti_zone_of[9] = True, 9
    t.anti_zone_of[10] = 11
    for node in (0, 1, 2, 4):
        _clear(t.w, node)
    _pods_on(t.w, 0, [9, 11])
    _pods_on(t.w, 1, [9])
    _pods_on(t.w, 2, [9, 11])
    _pods_on(t.w, 4, [10, 11])
    t.w.dest[t.zone == 0] = False
    return t.case()


def limit_one_spread() -> Case:
    """Group 1 has a hostPort (one a node) and spreads over hostnames at
    skew 2; candidate 8 holds 5 of its pods."""
    t = _topo(106)
    t.w.ports[1] = 4001
    _spread(t, 1, 1, skew=2)
    _small(t, 1)
    _clear(t.w, 8)
    _pods_on(t.w, 8, [1] * 5 + [0])
    return t.case()


def max_waves() -> Case:
    """Group 0 spreads over zones at skew 1 and selects zone 1 alone (its
    one eligible zone): one pod a wave. Candidate 3 (zone 1) holds 140 of
    its pods: 128 waves place 128, the cap drops the rest."""
    t = _topo(107, residents=(0, 2))
    w = t.w
    w.labels[t.zone == 1] = ZONE1_LABEL
    _spread(t, 0, 2)
    w.req[0] = (1, 0, 0, 0)
    w.sel[0] = ZONE1_LABEL
    w.group_ref[w.group_ref == 0] = 1
    w.cap[t.zone == 1, 0] = 200
    w.alloc[t.zone == 1, 0] = 10
    w.node_ok[:, t.zone == 1] = True
    w.dest[t.zone == 1] = True
    _clear(w, 3)
    _pods_on(w, 3, [0] * 140)
    return t.case()


def beyond_k() -> Case:
    """Candidates 6 and 13 hold pods of six groups (K = 4): groups 2 and 4
    spread, groups 8 and 10 past the fourth slot spread too and never
    place."""
    t = _topo(108)
    for g in (2, 4, 8, 10):
        _spread(t, g, 2 if g % 4 else 1)
        _small(t, g)
    for node in (6, 13):
        _clear(t.w, node)
        _pods_on(t.w, node, [1, 2, 3, 4, 8, 10, 10])
    return t.case()


def mixed_slots() -> Case:
    """Candidate 15 holds groups 1, 3 (unconstrained) and 2, 6 (a zone
    spread, a hostname spread); candidate 16 the same in another order."""
    t = _topo(109)
    _spread(t, 2, 2)
    _spread(t, 6, 1, skew=2)
    for g in (1, 2, 3, 6):
        _small(t, g, req=(1, 1, 0, 0))
    _clear(t.w, 15)
    _clear(t.w, 16)
    _pods_on(t.w, 15, [1, 2, 2, 3, 6, 6, 6])
    _pods_on(t.w, 16, [6, 6, 3, 2, 1, 1])
    return t.case()


def negative_free() -> Case:
    """A third of the nodes are over-committed on resource 1; groups 2 and
    5 (a zone spread, host self-affinity) request it."""
    t = _topo(110, load=0.4)
    over = np.arange(N) % 3 == 1
    t.w.alloc[over, 1] = t.w.cap[over, 1] + 1 + np.arange(over.sum()) % 5
    _spread(t, 2, 2)
    t.a_kind[5], t.a_self[5], t.aff_of[5] = 1, True, 5
    for g in (2, 5):
        _small(t, g, req=(1, 2, 0, 0))
    _pods_on(t.w, 9, [2, 2, 5, 5, 5])
    _pods_on(t.w, 21, [5, 2])
    return t.case()


def every_kind() -> Case:
    """Random constraints on every group (spread kind and skew, affinity
    kind, self flags, anti_self_zone, targets), hostPorts and
    self-anti-affinity as drain_cases draws them."""
    t = _topo(111, residents=(1, 6))
    rng = np.random.default_rng(111)
    g = G
    t.w.ports = np.where(rng.random(g) < 0.15, 4000 + np.arange(g), 0
                         ).astype(np.int32)
    t.w.anti = rng.random(g) < 0.15
    t.s_kind = rng.integers(0, 3, g).astype(np.int32)
    t.skew = rng.integers(1, 3, g).astype(np.int32)
    t.s_self = rng.random(g) < 0.7
    t.a_kind = np.where(rng.random(g) < 0.4, rng.integers(1, 3, g), 0
                        ).astype(np.int32)
    t.a_self = rng.random(g) < 0.6
    t.a_any = rng.random(g) < 0.3
    t.anti_zone_self = rng.random(g) < 0.2

    def target(p):
        own = np.arange(g, dtype=np.int32)
        other = rng.integers(0, g, g).astype(np.int32)
        return np.where(rng.random(g) < p, own, other)

    t.spread_of = np.where(t.s_kind > 0, target(0.7), -1).astype(np.int32)
    t.aff_of = np.where(t.a_kind > 0, np.where(t.a_self, np.arange(g), target(0.0)),
                        -1).astype(np.int32)
    t.anti_zone_of = np.where(t.anti_zone_self, np.arange(g), -1
                              ).astype(np.int32)
    t.anti_host_of = np.where(rng.random(g) < 0.1, target(0.0), -1
                              ).astype(np.int32)
    return t.case()


def over_mpn_spread() -> Case:
    """Every node has room for 1,000 pods of every group, past MPN = 160:
    group 2 spreads over hostnames, group 3 over zones (skew 2) and group 1
    (a hostPort: one a node) over zones; candidates 4, 5 and 20 hold
    twenty pods of each."""
    t = _topo(112)
    t.w.cap[:] = 1000
    t.w.alloc[:] = 0
    _spread(t, 2, 1)
    _spread(t, 3, 2, skew=2)
    _spread(t, 1, 2)
    t.w.ports[1] = 4001
    for g in (1, 2, 3):
        _small(t, g)
    for node in (4, 5, 20):
        _clear(t.w, node)
        _pods_on(t.w, node, [1] * 20 + [2] * 20 + [3] * 20)
    return t.case()


CASES = {
    "host_spread": host_spread,
    "zone_spread_self": zone_spread_self,
    "zone_anti_self": zone_anti_self,
    "affinity": affinity,
    "ghost_node": ghost_node,
    "limit_one_spread": limit_one_spread,
    "max_waves": max_waves,
    "beyond_k": beyond_k,
    "mixed_slots": mixed_slots,
    "negative_free": negative_free,
    "every_kind": every_kind,
    "over_mpn_spread": over_mpn_spread,
}


def world(seed: int, n: int, g: int, mpn: int, kk: int = 16, r: int = 8,
          residents_per_node: int = 8, candidates: int | None = None,
          load: float = 0.6, z: int = 16) -> Case:
    """A random world at the given widths (drain_cases.world's) in three
    zones (every eighth node keyless), every group constrained: a spread
    of either kind, else an affinity, else one pod a zone; targets the
    group itself. Every (candidate, slot) lane with pods is active."""
    p = 2 * residents_per_node * n + 16
    w = _world(seed, n=n, g=g, r=r, p=p,
               residents=(0, 2 * residents_per_node), mpn=mpn, kk=kk,
               load=load)
    w.cap = w.cap * 64
    w.alloc = (w.cap * np.random.default_rng(seed + 1).random(w.cap.shape)
               * load).astype(np.int32)
    w.req = w.req * 16
    w.anti[:] = False
    if candidates is not None:
        w.cand = w.cand[:candidates]
    rng = np.random.default_rng(seed + 2)
    zone = (1 + np.arange(n) % 3).astype(np.int32)
    zone[7::8] = 0
    own = np.arange(g, dtype=np.int32)
    kind = np.arange(g) % 4                     # spread host/zone, aff, anti
    s_kind = np.where(kind < 2, kind + 1, 0).astype(np.int32)
    a_kind = np.where(kind == 2, rng.integers(1, 3, g), 0).astype(np.int32)
    t = _Topo(w=w, zone=zone, s_kind=s_kind,
              skew=rng.integers(1, 3, g).astype(np.int32),
              s_self=np.ones(g, bool), a_kind=a_kind,
              a_self=np.ones(g, bool), a_any=rng.random(g) < 0.5,
              anti_zone_self=kind == 3,
              spread_of=np.where(s_kind > 0, own, -1).astype(np.int32),
              aff_of=np.where(a_kind > 0, own, -1).astype(np.int32),
              anti_zone_of=np.where(kind == 3, own, -1).astype(np.int32),
              anti_host_of=np.full(g, -1, np.int32))
    c = t.case()
    c.max_zones = z
    return c

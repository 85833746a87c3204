"""Seeded worlds for the drain sweep (`drain_kernel.sweep`): the cases that
`tests/test_torch_drain_kernel.py` holds byte-equal to the JAX package on
the CPU, and that `chip_smoke.py` and `tests/test_torch_kernels_cuda.py`
hold byte-equal to the plain version on the card.

`CASES` maps each case's name to a function that returns a `Case` on the
CPU: a tensor world (nodes, pending groups, resident pods), the
candidates and the allowed destinations. Every case but "wide" shares one
set of shapes (N = 37 nodes, G = 8 groups, R = 4, P = 200 pod rows, a
window of MPN = 16 places, K = 4 slots), so a reference compiles once for
all of them; "wide" has N = 1,031 nodes, past one tile of the kernel's
sweep and a multiple of none. Worlds are random where a case does not pin
them: capacities, requests, group selectors, self-anti-affinity and
hostPorts (limit one a node), node flags, pods that are invalid, unbound,
unmovable or blocking. Each case pins the edge its name says: an empty
node, blockers, more than K shapes on a node, a limit-one group, a
zero-request group (fit BIG), negative free capacity on destinations, no
allowed destination, a group spilling over many nodes, full and overfull
windows, a candidate subset in reverse order; for the kernel's fit plane
(a u16 capped at MPN): groups that fit more than MPN pods on every node,
limit_one beside that cap, and a candidate whose debit rows fall in every
tile of 2,048 nodes ("debits_every_tile", N = 4,500).

`world` builds a random world at any widths (the card tests and
`chip_smoke.py` use it at the main path's shapes).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    NodeTensors,
    PodGroupTensors,
    ScheduledPodTensors,
)

N, G, R, P, MPN, K = 37, 8, 4, 200, 16, 4
LABELS = (101, 102, 103)   # node label hashes a selector can ask for


@dataclass
class Case:
    nodes: NodeTensors
    specs: PodGroupTensors
    scheduled: ScheduledPodTensors
    candidates: torch.Tensor     # i32[C]
    dest_allowed: torch.Tensor   # bool[N]
    max_pods_per_node: int = MPN
    max_groups_per_node: int = K

    def to(self, device) -> "Case":
        def mv(tree):
            return type(tree)(**{k: None if v is None else v.to(device)
                                 for k, v in vars(tree).items()})

        return Case(mv(self.nodes), mv(self.specs), mv(self.scheduled),
                    self.candidates.to(device), self.dest_allowed.to(device),
                    self.max_pods_per_node, self.max_groups_per_node)

    def inputs(self):
        """The sweep's inputs (ops/drain.sweep_inputs) of this world."""
        from kubernetes_autoscaler_tpu_torch.ops.drain import sweep_inputs

        return sweep_inputs(self.nodes, self.specs, self.scheduled,
                            self.candidates, self.dest_allowed,
                            self.max_pods_per_node)


def _t(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


@dataclass
class _World:
    """numpy fields of a world, edited by the cases before `case()`."""

    cap: np.ndarray
    alloc: np.ndarray
    labels: np.ndarray
    node_ok: np.ndarray        # [3, N] valid, ready, schedulable
    req: np.ndarray
    sel: np.ndarray
    ports: np.ndarray
    anti: np.ndarray
    node_idx: np.ndarray
    group_ref: np.ndarray
    flags: np.ndarray          # [3, P] valid, movable, blocks
    dest: np.ndarray
    cand: np.ndarray
    mpn: int
    kk: int

    def case(self) -> Case:
        i32, b8 = torch.int32, torch.bool
        n, r = self.cap.shape
        g = self.req.shape[0]
        p = self.node_idx.shape[0]
        zn = np.zeros((n, 1), np.int32)
        nodes = NodeTensors(
            cap=_t(self.cap, i32), alloc=_t(self.alloc, i32),
            label_hash=_t(np.stack([self.labels, np.zeros(n, np.int32)], 1), i32),
            taint_exact=_t(zn, i32), taint_key=_t(zn, i32),
            used_ports=_t(zn, i32), zone_id=_t(np.zeros(n, np.int32), i32),
            group_id=_t(np.zeros(n, np.int32), i32),
            ready=_t(self.node_ok[1], b8), schedulable=_t(self.node_ok[2], b8),
            valid=_t(self.node_ok[0], b8))
        zg = np.zeros((g, 1), np.int32)
        specs = PodGroupTensors(
            req=_t(self.req, i32), count=_t(np.ones(g, np.int32), i32),
            sel_req=_t(self.sel[:, None, None], i32), sel_neg=_t(zg, i32),
            tol_exact=_t(zg, i32), tol_key=_t(zg, i32),
            tolerate_all=_t(np.zeros(g, bool), b8),
            port_hash=_t(self.ports[:, None], i32),
            anti_affinity_self=_t(self.anti, b8),
            valid=_t(np.ones(g, bool), b8),
            needs_host_check=_t(np.zeros(g, bool), b8))
        scheduled = ScheduledPodTensors(
            req=_t(self.req[np.clip(self.group_ref, 0, g - 1)], i32),
            node_idx=_t(self.node_idx, i32), group_ref=_t(self.group_ref, i32),
            movable=_t(self.flags[1], b8), blocks=_t(self.flags[2], b8),
            valid=_t(self.flags[0], b8))
        assert p == self.flags.shape[1]
        return Case(nodes, specs, scheduled, _t(self.cand, i32),
                    _t(self.dest, b8), self.mpn, self.kk)


def _world(seed: int, n: int = N, g: int = G, r: int = R, p: int = P,
           residents: tuple[int, int] = (0, 5), mpn: int = MPN, kk: int = K,
           load: float = 0.8) -> _World:
    """A random world: node i gets residents[0]..residents[1] pods of
    random groups, in random pod-row order; the rows past them are invalid
    and unbound; some residents are invalid, unbound, unmovable or
    blocking."""
    rng = np.random.default_rng(seed)
    cap = rng.integers(8, 41, size=(n, r)).astype(np.int32)
    alloc = (cap * np.clip(rng.uniform(load - 0.3, load + 0.15, (n, r)), 0, 1)
             ).astype(np.int32)
    per_node = rng.integers(residents[0], residents[1] + 1, size=n)
    node_of = np.repeat(np.arange(n, dtype=np.int32), per_node)
    if node_of.size > p:
        raise ValueError(f"{node_of.size} residents do not fit {p} pod rows")
    node_idx = np.full(p, -1, np.int32)
    node_idx[:node_of.size] = node_of
    group_ref = rng.integers(0, g, size=p).astype(np.int32)
    valid = np.zeros(p, bool)
    valid[:node_of.size] = rng.random(node_of.size) < 0.95
    movable = rng.random(p) < 0.85
    blocks = rng.random(p) < 0.02
    # a few valid pods bound to no node
    loose = rng.random(p) < 0.02
    node_idx[loose & valid] = -1
    perm = rng.permutation(p)
    req = rng.integers(0, 9, size=(g, r)).astype(np.int32)
    req[:, 0] = np.maximum(req[:, 0], 1)
    sel = np.where(rng.random(g) < 0.3, rng.choice(LABELS, size=g), 0)
    return _World(
        cap=cap, alloc=alloc,
        labels=rng.choice(LABELS, size=n).astype(np.int32),
        node_ok=rng.random((3, n)) < np.array([[0.97], [0.95], [0.95]]),
        req=req, sel=sel.astype(np.int32),
        ports=np.where(rng.random(g) < 0.15, 4000 + np.arange(g), 0)
        .astype(np.int32),
        anti=rng.random(g) < 0.15,
        node_idx=node_idx[perm], group_ref=group_ref[perm],
        flags=np.stack([valid, movable, blocks])[:, perm],
        dest=rng.random(n) < 0.9, cand=np.arange(n, dtype=np.int32),
        mpn=mpn, kk=kk)


def _pods_on(w: _World, node: int, groups, movable=True, blocks=False):
    """Put pods of `groups` (one a group entry) on `node`, in free pod rows
    (invalid, unbound ones)."""
    free_rows = np.flatnonzero((~w.flags[0]) & (w.node_idx < 0))
    if len(groups) > free_rows.size:
        raise ValueError("no free pod rows left")
    rows = free_rows[:len(groups)]
    w.node_idx[rows] = node
    w.group_ref[rows] = np.asarray(groups, np.int32)
    w.flags[0, rows] = True
    w.flags[1, rows] = movable
    w.flags[2, rows] = blocks


def _clear(w: _World, node: int) -> None:
    """Unbind every pod of `node`."""
    on = w.node_idx == node
    w.node_idx[on] = -1
    w.flags[0, on] = False


def mixed() -> Case:
    return _world(1).case()


def empty_node() -> Case:
    w = _world(2)
    for node in (0, 5, 36):
        _clear(w, node)
    w.node_ok[:, [0, 5, 36]] = True
    return w.case()


def blocker() -> Case:
    w = _world(3)
    _pods_on(w, 4, [1, 2], blocks=True)
    _pods_on(w, 9, [3], movable=False, blocks=True)
    _pods_on(w, 12, [0], movable=False)
    return w.case()


def too_many_shapes() -> Case:
    """Node 6 holds 7 groups and node 7 all 8 (K = 4): the groups past the
    fourth never place; their pods count in n_failed."""
    w = _world(4, load=0.2)
    _clear(w, 6)
    _clear(w, 7)
    _pods_on(w, 6, [0, 1, 2, 3, 4, 5, 6, 6])
    _pods_on(w, 7, [7, 6, 5, 4, 3, 2, 1, 0])
    return w.case()


def limit_one() -> Case:
    """Group 2 is self-anti-affine and group 3 has a hostPort (one a node):
    candidate 10 holds six of each."""
    w = _world(5, load=0.2)
    w.anti[:] = False
    w.anti[2] = True
    w.ports[:] = 0
    w.ports[3] = 4003
    w.req[2] = [1, 1, 0, 0]
    w.req[3] = [1, 0, 1, 0]
    w.sel[[2, 3]] = 0
    _clear(w, 10)
    _pods_on(w, 10, [2] * 6 + [3] * 6)
    return w.case()


def zero_request() -> Case:
    """Groups 0 and 5 request nothing: every allowed node fits the whole
    count (BIG) and takes it."""
    w = _world(6)
    w.req[[0, 5]] = 0
    w.sel[[0, 5]] = 0
    _pods_on(w, 3, [0] * 5 + [5] * 3 + [1])
    return w.case()


def negative_free() -> Case:
    """A third of the nodes are over-committed (free < 0 on a resource):
    they fit nothing."""
    w = _world(7, load=0.4)
    over = np.arange(N) % 3 == 1
    w.alloc[over, 1] = w.cap[over, 1] + 1 + np.arange(over.sum()) % 5
    return w.case()


def no_destination() -> Case:
    """No destination is allowed: every candidate with a movable pod
    fails."""
    w = _world(8)
    w.dest[:] = False
    return w.case()


def spill() -> Case:
    """Candidate 20 holds 14 pods of group 1, which fits one or two a node
    elsewhere: its destinations come from many runs."""
    w = _world(9)
    w.req[1] = [10, 1, 1, 0]
    w.sel[1] = 0
    w.anti[1] = False
    w.ports[1] = 0
    w.cap[:, 0] = 30
    w.alloc[:, 0] = np.where(np.arange(N) % 2 == 0, 15, 5)
    _clear(w, 20)
    _pods_on(w, 20, [1] * 14 + [0, 2])
    w.dest[:] = True
    return w.case()


def full_window() -> Case:
    """Node 2 holds exactly MPN pods and node 3 MPN + 3: the window holds
    the first MPN of each (sorted by pod row)."""
    w = _world(10, residents=(0, 3), load=0.1)
    _clear(w, 2)
    _clear(w, 3)
    _pods_on(w, 2, [i % 3 for i in range(MPN)])
    _pods_on(w, 3, [(i * 5) % G for i in range(MPN + 3)])
    return w.case()


def reverse_subset() -> Case:
    """Every third node, in reverse order, node 0 twice."""
    w = _world(11)
    w.cand = np.concatenate([np.arange(N - 1, -1, -3), [0]]).astype(np.int32)
    return w.case()


def wide() -> Case:
    """N = 1,031 (a multiple of no tile): 60 candidates. Half the groups fit
    only on the last five nodes, past the first 1,024; nodes 18 and 36 hold
    8 pods of one of them, more than those five take."""
    n, p = 1031, 2200
    w = _world(12, n=n, p=p, residents=(0, 3), load=0.9)
    w.sel[:] = np.where(np.arange(G) % 2 == 0, LABELS[0], 0)
    w.labels[:] = LABELS[1]
    w.labels[1026:] = LABELS[0]            # group 0, 2, ... fit only there
    w.alloc[1026:] = w.cap[1026:] - 12
    w.node_ok[:, 1026:] = True
    w.dest[1026:] = True
    for node in (18, 36):                  # more than those nodes hold
        _clear(w, node)
        _pods_on(w, node, [0] * 8)
    w.cand = np.concatenate([np.arange(0, n, 18), [1030, 1025]]).astype(np.int32)
    return w.case()


def over_mpn() -> Case:
    """Every node has room for 1,000 pods of every group (past MPN = 16,
    the fit plane's cap): each candidate's pods land on the first allowed
    nodes, several a node."""
    w = _world(13)
    w.cap[:] = 1000
    w.alloc[:] = 0
    w.req[:] = 1
    return w.case()


def limit_one_cap() -> Case:
    """Group 2 is self-anti-affine (one a node) and fits 500 a node (past
    the cap) on every node: candidate 9 holds nine of its pods, spread one a
    node."""
    w = _world(14, load=0.2)
    w.cap[:] = 500
    w.alloc[:] = 0
    w.anti[:] = False
    w.anti[2] = True
    w.ports[:] = 0
    w.req[2] = [1, 0, 0, 0]
    w.sel[2] = 0
    _clear(w, 9)
    _pods_on(w, 9, [2] * 9 + [4])
    return w.case()


def debits_every_tile() -> Case:
    """N = 4,500: three tiles of 2,048 nodes. Groups 0 (a hostPort: one a
    node) and 1 fit only nodes 100, 2,100 and 4,100, two pods each; four
    candidates hold three pods of each. Group 0's slot debits a node in
    every tile, and group 1's slot finds its room there, by each node's
    free capacity less its debit row."""
    n, p = 4500, 4600
    w = _world(15, n=n, p=p, residents=(0, 1), load=0.5)
    w.labels[:] = LABELS[1]
    room = [100, 2100, 4100]
    w.labels[room] = LABELS[0]
    w.sel[[0, 1]] = LABELS[0]
    w.req[[0, 1]] = [1, 0, 0, 0]
    w.ports[:] = 0
    w.ports[0] = 4000
    w.anti[:] = False
    w.alloc[room] = w.cap[room] - 2
    w.node_ok[:, room] = True
    w.dest[room] = True
    cand = [7, 8, 3000, 4499]
    for node in cand:
        _clear(w, node)
        _pods_on(w, node, [0] * 3 + [1] * 3)
    w.cand = np.asarray(cand + [100], np.int32)
    return w.case()


CASES = {
    "mixed": mixed,
    "empty_node": empty_node,
    "blocker": blocker,
    "too_many_shapes": too_many_shapes,
    "limit_one": limit_one,
    "zero_request": zero_request,
    "negative_free": negative_free,
    "no_destination": no_destination,
    "spill": spill,
    "full_window": full_window,
    "reverse_subset": reverse_subset,
    "wide": wide,
    "over_mpn": over_mpn,
    "limit_one_cap": limit_one_cap,
    "debits_every_tile": debits_every_tile,
}


def world(seed: int, n: int, g: int, mpn: int, kk: int = 16, r: int = 8,
          residents_per_node: int = 8, candidates: int | None = None,
          load: float = 0.6) -> Case:
    """A random world at the given widths, `residents_per_node` pods on
    every node on average (up to twice that), candidates the first
    `candidates` nodes (every node by default)."""
    p = 2 * residents_per_node * n + 16
    w = _world(seed, n=n, g=g, r=r, p=p,
               residents=(0, 2 * residents_per_node), mpn=mpn, kk=kk,
               load=load)
    w.cap = w.cap * 64
    w.alloc = (w.cap * np.random.default_rng(seed + 1).random(w.cap.shape)
               * load).astype(np.int32)
    w.req = w.req * 16
    if candidates is not None:
        w.cand = w.cand[:candidates]
    return w.case()

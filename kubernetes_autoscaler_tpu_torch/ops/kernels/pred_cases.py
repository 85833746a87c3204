"""Seeded worlds for the predicate plane (`predicate_kernel.plane`): the
cases that `tests/test_torch_predicate_kernel.py` holds byte-equal to the
JAX package on the CPU, and that `chip_smoke.py` and
`tests/test_torch_kernels_cuda.py` hold byte-equal to the plain version on
the card.

`CASES` maps each case's name to a function that returns a `Case` on the
CPU: node planes, group planes and a group mask, drawn with numpy from a
seed. Hashes come from a small vocabulary (so probes collide with label,
taint and port slots), with zeros sprinkled in every plane; INT32_MIN and
-1 are in every vocabulary. Most cases share one set of widths (N = 37
nodes, G = 9 groups, L = 8, T = 3, NP = 4, S = 3, A = 2, Sn = 2, Tl = 3,
PP = 2, R = 6), so a reference compiles once for all of them. Each case
pins the edge its name says: a vocabulary of two hashes, mostly zero slots
(whole zero rows, inactive taints with a key, active taints without one),
groups that tolerate everything on nodes tainted everywhere, invalid groups
and unavailable nodes, a `cap - alloc` that wraps past int32, template rows
(NG = 5: no allocation, no used port, ready and schedulable), the default
`Dims()` widths past one tile of nodes and one chunk of groups ("wide", N =
1,031, G = 37), every width 1 ("narrow", R = 4: no extended resource) and
widths past the kernel's register fast paths ("many_slots").

Every world also has resident pods (`Case.scheduled`) and self-anti-affine
groups (`specs.anti_affinity_self`) for the resident term that the filter
and the drain's preparation AND into the static plane: three pods a node on
average, some invalid, some with node_idx -1, some on unavailable nodes,
several pods of a group on one node, and a few rows outside the plane (a
group row of -1 or -G, which the reference reads from the end, and a group
row or node index past the plane, which it drops). "residents" and
"residents_wide" (the "wide" widths, G = 37 across two resident words) make
them dense.

`FUNCTIONS` names the public tensor functions of `ops/predicates.py` (and
their `check_resources` variants); `public` calls one through either
package's module, `plane_args` gives the arguments that function hands the
wrapper. `world` builds a random world at any widths (the card tests and
`chip_smoke.py` use it at the main path's shapes).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    Dims,
    NodeTensors,
    PodGroupTensors,
    ScheduledPodTensors,
)
from kubernetes_autoscaler_tpu_torch.ops.kernels import predicate_kernel as pk

N, G, R = 37, 9, 6
WIDTHS = {"L": 8, "T": 3, "NP": 4, "S": 3, "A": 2, "Sn": 2, "Tl": 3, "PP": 2}
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def dims_widths(dims: Dims) -> dict[str, int]:
    """The plane widths of a `Dims`."""
    return {"L": dims.max_labels, "T": dims.max_taints,
            "NP": dims.max_node_ports, "S": dims.max_sel_terms,
            "A": dims.max_sel_alts, "Sn": dims.max_neg_terms,
            "Tl": dims.max_tolerations, "PP": dims.max_pod_ports}


@dataclass
class Case:
    nodes: NodeTensors
    specs: PodGroupTensors
    group_mask: torch.Tensor     # bool[G]
    scheduled: ScheduledPodTensors   # the resident pods

    def to(self, device) -> "Case":
        def mv(tree):
            return type(tree)(**{k: None if v is None else v.to(device)
                                 for k, v in vars(tree).items()})

        return Case(mv(self.nodes), mv(self.specs), self.group_mask.to(device),
                    mv(self.scheduled))


def _t(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


@dataclass
class _World:
    """numpy fields of a world, edited by the cases before `case()`."""

    labels: np.ndarray     # [N, L]
    te: np.ndarray         # [N, T] taint exact hashes
    tk: np.ndarray         # [N, T] taint key hashes
    ports: np.ndarray      # [N, NP]
    node_ok: np.ndarray    # [3, N] valid, ready, schedulable
    cap: np.ndarray        # [N, R]
    alloc: np.ndarray      # [N, R]
    sel: np.ndarray        # [G, S, A]
    neg: np.ndarray        # [G, Sn]
    tex: np.ndarray        # [G, Tl]
    tky: np.ndarray        # [G, Tl]
    tol_all: np.ndarray    # [G]
    gports: np.ndarray     # [G, PP]
    gvalid: np.ndarray     # [G]
    req: np.ndarray        # [G, R]
    mask: np.ndarray       # [G] the group mask
    anti: np.ndarray       # [G] anti_affinity_self
    res: np.ndarray        # [3, P] resident valid, node_idx, group_ref

    def case(self) -> Case:
        i32, b8 = torch.int32, torch.bool
        n, g = self.cap.shape[0], self.req.shape[0]
        nodes = NodeTensors(
            cap=_t(self.cap, i32), alloc=_t(self.alloc, i32),
            label_hash=_t(self.labels, i32), taint_exact=_t(self.te, i32),
            taint_key=_t(self.tk, i32), used_ports=_t(self.ports, i32),
            zone_id=_t(np.zeros(n, np.int32), i32),
            group_id=_t(np.zeros(n, np.int32), i32),
            ready=_t(self.node_ok[1], b8), schedulable=_t(self.node_ok[2], b8),
            valid=_t(self.node_ok[0], b8))
        specs = PodGroupTensors(
            req=_t(self.req, i32), count=_t(np.ones(g, np.int32), i32),
            sel_req=_t(self.sel, i32), sel_neg=_t(self.neg, i32),
            tol_exact=_t(self.tex, i32), tol_key=_t(self.tky, i32),
            tolerate_all=_t(self.tol_all, b8), port_hash=_t(self.gports, i32),
            anti_affinity_self=_t(self.anti, b8),
            valid=_t(self.gvalid, b8),
            needs_host_check=_t(np.zeros(g, bool), b8))
        p = self.res.shape[1]
        scheduled = ScheduledPodTensors(
            req=_t(np.ones((p, self.cap.shape[1]), np.int32), i32),
            node_idx=_t(self.res[1], i32), group_ref=_t(self.res[2], i32),
            movable=_t(np.ones(p, bool), b8), blocks=_t(np.zeros(p, bool), b8),
            valid=_t(self.res[0] != 0, b8))
        return Case(nodes, specs, _t(self.mask, b8), scheduled)


def _residents(rng, n: int, g: int, per_node: float) -> np.ndarray:
    """[3, P] (valid, node_idx, group_ref) of about `per_node` pods a node:
    85 % valid, 5 % with node_idx -1, a fifth of them a copy of an earlier
    pod (several pods of a group on one node), and about 2 % outside the
    plane (group_ref -1, -g, -g - 1, g, or node_idx n)."""
    p = max(int(per_node * n), 1)
    valid = rng.random(p) < 0.85
    node = rng.integers(0, n, p)
    node[rng.random(p) < 0.05] = -1
    grp = rng.integers(0, g, p)
    dup = np.flatnonzero(rng.random(p) < 0.2)
    src = rng.integers(0, p, dup.size)
    node[dup], grp[dup] = node[src], grp[src]
    edge = np.flatnonzero(rng.random(p) < 0.02)
    for k, i in enumerate(edge):
        if k % 5 == 4:
            node[i] = n
        else:
            grp[i] = (-1, -g, -g - 1, g)[k % 5]
    return np.stack([valid.astype(np.int64), node, grp]).astype(np.int32)


def _world(seed: int, n: int = N, g: int = G, r: int = R,
           widths: dict | None = None, vocab: int = 8,
           zero: float = 0.4, residents: float = 3.0) -> _World:
    """A random world: every hash from a vocabulary of `vocab` non-zero
    int32 values (INT32_MIN and -1 among them), a share `zero` of the
    label and toleration slots 0 (more of the taint, selector and port
    slots); capacities, allocations and requests such that a request
    sometimes exceeds the free capacity, which is sometimes negative;
    90 % of nodes and groups available and valid, 20 % of groups
    tolerating everything, 60 % of groups in the mask; `residents` resident
    pods a node on average (`_residents`), 40 % of groups self-anti-affine."""
    w = {**WIDTHS, **(widths or {})}
    rng = np.random.default_rng(seed)
    pool = rng.integers(INT32_MIN, INT32_MAX, size=vocab, dtype=np.int64)
    pool[pool == 0] = 1
    pool[:2] = (INT32_MIN, -1)
    pool = pool.astype(np.int32)

    def hashes(shape, z=zero):
        v = rng.choice(pool, size=shape)
        v[rng.random(shape) < z] = 0
        return v.astype(np.int32)

    return _World(
        labels=hashes((n, w["L"])), te=hashes((n, w["T"]), 0.75),
        tk=hashes((n, w["T"]), 0.3), ports=hashes((n, w["NP"]), 0.6),
        node_ok=rng.random((3, n)) < 0.9,
        cap=rng.integers(20, 64, (n, r)).astype(np.int32),
        alloc=rng.integers(0, 32, (n, r)).astype(np.int32),
        sel=hashes((g, w["S"], w["A"]), 0.75), neg=hashes((g, w["Sn"]), 0.85),
        tex=hashes((g, w["Tl"])), tky=hashes((g, w["Tl"])),
        tol_all=rng.random(g) < 0.2, gports=hashes((g, w["PP"]), 0.7),
        gvalid=rng.random(g) < 0.9,
        req=rng.integers(0, 16, (g, r)).astype(np.int32),
        mask=rng.random(g) < 0.6, anti=rng.random(g) < 0.4,
        res=_residents(rng, n, g, residents))


def world(seed: int, n: int, g: int, dims: Dims = Dims(),
          r: int = 8) -> Case:
    """A random world at these widths (the main path's: `Dims()`, R = 8),
    with a vocabulary of 64 hashes."""
    return _world(seed, n, g, r, dims_widths(dims), vocab=64).case()


def _offset(t: torch.Tensor, k: int) -> torch.Tensor:
    """A contiguous copy of t that starts k elements into a larger buffer."""
    buf = torch.zeros(t.numel() + k, dtype=t.dtype, device=t.device)
    view = buf[k:].view(t.shape)
    view.copy_(t)
    return view


def shifted(case: Case, k: int) -> Case:
    """The same case with every plane a contiguous view that starts k
    elements into a larger buffer, so that no slice of it starts on a
    16-byte boundary (the kernel's bulk copies then leave edges to plain
    loads)."""
    def mv(tree):
        return type(tree)(**{name: None if t is None else _offset(t, k)
                             for name, t in vars(tree).items()})

    return Case(mv(case.nodes), mv(case.specs), _offset(case.group_mask, k),
                mv(case.scheduled))


def _collisions() -> Case:
    return _world(1, vocab=2).case()


def _zero_slots() -> Case:
    w = _world(2, zero=0.85)
    w.labels[:5] = 0                    # nodes with no label at all
    w.sel[:3] = 0                       # groups with no requirement
    w.neg[:3] = 0
    w.te[:, 0], w.tk[:, 0] = 0, w.tk[:, 1]   # inactive taints with a key
    w.tk[::2, 1] = 0                    # active taints without a key hash
    w.tex[3:5] = 0                      # zero toleration probes
    w.tky[3:5] = 0
    w.ports[:7] = 0
    return w.case()


def _tolerate_all() -> Case:
    w = _world(3, vocab=5)
    w.te[w.te == 0] = w.te.flat[np.flatnonzero(w.te)[0]]  # tainted everywhere
    w.tol_all[::2] = True
    return w.case()


def _gates() -> Case:
    w = _world(4)
    rng = np.random.default_rng(40)
    w.node_ok = rng.random(w.node_ok.shape) < 0.6
    w.gvalid[::2] = False
    w.mask[:] = True
    w.mask[1] = False
    return w.case()


def _wrap() -> Case:
    """cap - alloc past int32: INT32_MIN + c less a positive allocation
    wraps to a large positive free, INT32_MAX - c less a negative one to a
    negative free; requests at the extremes too."""
    w = _world(5)
    w.cap[::3] = INT32_MIN + np.arange(w.cap.shape[1], dtype=np.int32)
    w.alloc[::3] = 7
    w.cap[1::3] = INT32_MAX - 3
    w.alloc[1::3] = -9
    w.req[0] = INT32_MAX
    w.req[1] = INT32_MIN
    w.req[2] = -5
    return w.case()


def _templates() -> Case:
    """Template rows as NodeGroupTensors.as_node_tensors makes them: no
    allocation, no used port, ready and schedulable."""
    w = _world(6, n=5)
    w.alloc[:] = 0
    w.ports[:] = 0
    w.node_ok[1:] = True
    return w.case()


def _wide() -> Case:
    """The default Dims() widths, past one tile of nodes and one chunk of
    groups, a multiple of neither."""
    return _world(7, n=1031, g=37, r=8, widths=dims_widths(Dims()),
                  vocab=40).case()


def _narrow() -> Case:
    return _world(8, r=4, widths=dict.fromkeys(WIDTHS, 1), vocab=3).case()


def _many_slots() -> Case:
    """Widths past the kernel's fast paths: more than 64 label and port
    slots a node, more than 8 taint slots (two words of taint bits a
    node), more than 32 entries in a group's probe row and in its
    tolerations, more than 32 alternatives a term."""
    w = _world(11, n=70, g=40, r=5,
               widths={"L": 100, "T": 40, "NP": 70, "S": 2, "A": 40,
                       "Sn": 36, "Tl": 40, "PP": 36}, vocab=30)
    w.te[:, :30] = 0              # most nodes keep a few active taints
    w.te[::7, 35] = w.tex[3, 0] or 5
    w.sel[:, :, :34] = 0          # the probes sit past entry 32 of a row
    w.neg[:, :33] = 0
    w.gports[:, :34] = 0
    w.ports[:, 3:60] = 0
    return w.case()


def _residents_dense() -> Case:
    """Most groups self-anti-affine, six resident pods a node."""
    w = _world(9, residents=6.0)
    w.anti[:] = True
    w.anti[::4] = False
    return w.case()


def _residents_wide() -> Case:
    """The "wide" widths (G = 37: two resident words, the second partial)
    with every group self-anti-affine and residents on every node."""
    w = _world(10, n=1031, g=37, r=8, widths=dims_widths(Dims()), vocab=40,
               residents=4.0)
    w.anti[:] = True
    return w.case()


CASES = {
    "random": lambda: _world(0).case(),
    "collisions": _collisions,
    "zero_slots": _zero_slots,
    "tolerate_all": _tolerate_all,
    "gates": _gates,
    "wrap": _wrap,
    "templates": _templates,
    "wide": _wide,
    "narrow": _narrow,
    "many_slots": _many_slots,
    "residents": _residents_dense,
    "residents_wide": _residents_wide,
}

# the public tensor functions of ops/predicates.py: (name, check_resources)
FUNCTIONS = {
    "feasibility_mask": ("feasibility_mask", False),
    "feasibility_mask_resources": ("feasibility_mask", True),
    "selector_match": ("selector_match", None),
    "taints_tolerated": ("taints_tolerated", None),
    "ports_free": ("ports_free", None),
    "resources_fit": ("resources_fit", None),
    "reason_mask": ("reason_mask", False),
    "reason_mask_resources": ("reason_mask", True),
    "reason_mask_for_groups": ("reason_mask_for_groups", False),
    "reason_mask_for_groups_resources": ("reason_mask_for_groups", True),
}


def public(name: str, preds, nodes, specs, group_mask):
    """FUNCTIONS[name] through `preds` (either package's ops.predicates) on
    either package's trees."""
    fn, res = FUNCTIONS[name]
    f = getattr(preds, fn)
    if fn == "selector_match":
        return f(nodes.label_hash, specs)
    if fn == "taints_tolerated":
        return f(nodes.taint_exact, nodes.taint_key, specs)
    if fn == "ports_free":
        return f(nodes.used_ports, specs)
    if fn == "resources_fit":
        return f(nodes, specs)
    if fn == "reason_mask_for_groups":
        return f(nodes, specs, group_mask, check_resources=res)
    return f(nodes, specs, check_resources=res)


def plane_args(name: str, case: Case) -> tuple:
    """(nodes, specs, checks, bits, group_mask) as FUNCTIONS[name] hands
    them to `predicate_kernel.plane`."""
    fn, res = FUNCTIONS[name]
    nd = case.nodes
    single = {
        "selector_match": (pk.NodePlanes(label_hash=nd.label_hash), pk.SELECTOR),
        "taints_tolerated": (pk.NodePlanes(taint_exact=nd.taint_exact,
                                           taint_key=nd.taint_key), pk.TAINTS),
        "ports_free": (pk.NodePlanes(used_ports=nd.used_ports), pk.PORTS),
        "resources_fit": (nd, pk.RESOURCES)}
    if fn in single:
        nodes, checks = single[fn]
        return nodes, case.specs, checks, False, None
    checks = pk.STATIC | (pk.RESOURCES if res else 0)
    mask = case.group_mask if fn == "reason_mask_for_groups" else None
    return nd, case.specs, checks, fn != "feasibility_mask", mask

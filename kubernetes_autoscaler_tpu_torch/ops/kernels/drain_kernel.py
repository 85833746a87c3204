"""The drain sweep: the wrapper of the CUDA kernel and its plain PyTorch
version.

Replaces the reference package's `ops/drain.py` per-candidate program
(`one_candidate`, :232-347: the window gather, the compaction into K group
slots, the `lax.scan` of the K-step first fit at :312-325 and the per-pod
destinations) under `lax.map(vmap(...))` at :352, and its reason pass
(`_failure_reasons_jit`, :438-492); neither is a Pallas kernel. The kernel
is `csrc/drain.cu`, one CTA a candidate; its header says what bounds it and
how its design answers that (the shared free plane read through the L2, a
candidate's own debits in shared memory, no [C, N, R] plane).

`SweepInputs` is what the sweep needs once the placement-independent
preparation is done (ops/drain.sweep_inputs: the predicate plane, the
destinations, the pods sorted by node). `sweep` gives, for every candidate,
(drainable, has_blocker, n_moved, n_failed, dest_node, pod_slot) or, with
`explain`, (reason, fail_group, n_unplaced): the leaves of
ops/drain.RemovalResult (less `feas`) and RemovalReasons.

`TopoInputs` (ops/drain.topo_inputs) makes the sweep topology-aware, the
reference's program with constraints (drain.py:195-219, :257-309): the
candidate's own residents leave its zone's counts (the ghost node), the
zone gate joins each slot's predicate row, and a constrained group's slot
re-places by waves (the reference's `place_group_constrained`). On the
card that is the same one launch, the waves inside the candidate's CTA;
the plain version runs them through `constrained_kernel.place_lanes_plain`
on either device, so no kernel runs in it.

The device of the tensors decides: CPU tensors go through `sweep_plain`,
CUDA tensors through the kernel (one launch for all candidates, nothing
read back to the host), and anything the kernel does not take raises, on
either device. There is no fallback from the kernel to the plain version.
`chunk` (candidates a chunk) bounds the plain version's memory and changes
no result; the kernel takes every candidate at once and ignores it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from kubernetes_autoscaler_tpu_torch.models.cluster_state import _Tree
from kubernetes_autoscaler_tpu_torch.ops.constrained import (
    BIG,
    MAX_WAVES,
    GroupConstraints,
)
from kubernetes_autoscaler_tpu_torch.ops.kernels.pack_kernel import _check
from kubernetes_autoscaler_tpu_torch.ops.pack import fit_count

SOURCE = "drain.cu"

I32 = torch.int32

# per-candidate drain failure reasons (the scale-down reason plane); codes
# are the reference package's
DRAIN_OK = 0
DRAIN_BLOCKED_BY_POD = 1       # a pod forbids draining (drainability rules)
DRAIN_NO_PLACE_FOR_GROUP = 2   # fail_group says WHICH pod shape found no room
DRAIN_TOO_MANY_SHAPES = 3      # > max_groups_per_node distinct shapes resident

# memory budget of one [C, N, R] int32 free-capacity plane of the plain
# version's first fit
CHUNK_BYTES = 256 * 2 ** 20

# csrc/drain.cu's Field enum, in order
FIELDS = ("candidates", "starts", "pad_order", "node_idx", "group_ref", "valid",
          "movable", "blocks", "free", "feas", "dest_ok", "limit_one", "req",
          "out0", "out1", "out2", "out3", "dest_node", "pod_slot", "nodes",
          "zone_cl", "zone_valid", "s_kind", "s_skew", "s_self", "a_kind",
          "a_self", "a_any", "anti_self_zone", "spread_cnt", "aff_cnt",
          "anti_zone_cnt", "s_elig", "anti_zone", "aff_zone", "cnt_zone",
          "elig_zone", "perm", "skey", "waves", "fit0")


def default_chunk(c_total: int, n: int, r: int) -> int:
    """Candidates per chunk: as many as keep one [C, N, R] int32 plane
    within CHUNK_BYTES, split evenly over the chunks that needs."""
    most = max(1, CHUNK_BYTES // (n * r * 4))
    n_chunks = max(1, -(-c_total // most))
    return max(1, -(-c_total // n_chunks))


@dataclass(frozen=True)
class SweepInputs(_Tree):
    """The sweep's inputs after the placement-independent preparation."""

    candidates: torch.Tensor  # i32[C] node indices to try draining
    starts: torch.Tensor      # i32[N] first place of each node in pad_order
    pad_order: torch.Tensor   # i32[P + MPN] pods sorted by node, then -1 pads
    node_idx: torch.Tensor    # i32[P] ScheduledPodTensors.node_idx
    group_ref: torch.Tensor   # i32[P] ScheduledPodTensors.group_ref
    valid: torch.Tensor       # bool[P]
    movable: torch.Tensor     # bool[P]
    blocks: torch.Tensor      # bool[P]
    free: torch.Tensor        # i32[N, R] free capacity before any drain
    feas: torch.Tensor        # bool[G, N] predicate plane (pre-capacity)
    dest_ok: torch.Tensor     # bool[N] allowed, valid, ready, schedulable
    limit_one: torch.Tensor   # bool[G] at most one pod of the group a node
    req: torch.Tensor         # i32[G, R]

    @property
    def mpn(self) -> int:
        """Pods a candidate's window holds (max_pods_per_node)."""
        return self.pad_order.shape[0] - self.node_idx.shape[0]

    def to(self, device) -> "SweepInputs":
        return SweepInputs(**{k: v.to(device) for k, v in vars(self).items()})


@dataclass(frozen=True)
class TopoInputs(_Tree):
    """The topology-aware sweep's candidate-independent inputs: the zone
    rows, the groups' constraint scalars, the resident count planes and
    their zone totals over the real nodes (ops/drain.topo_inputs). The host
    gates are already in SweepInputs.feas."""

    zone_cl: torch.Tensor         # i32[N] zone id clipped to [0, Z)
    zone_valid: torch.Tensor      # bool[N] the node has a zone label
    s_kind: torch.Tensor          # i32[G] 0 none / 1 hostname / 2 zone spread
    s_skew: torch.Tensor          # i32[G]
    s_self: torch.Tensor          # bool[G]
    a_kind: torch.Tensor          # i32[G] 0 none / 1 hostname / 2 zone affinity
    a_self: torch.Tensor          # bool[G]
    a_any: torch.Tensor           # bool[G]
    anti_self_zone: torch.Tensor  # bool[G]
    spread_cnt: torch.Tensor      # i32[G, N] resident spread matches
    aff_cnt: torch.Tensor         # i32[G, N] resident affinity matches
    anti_zone_cnt: torch.Tensor   # i32[G, N] resident zone anti-affinity matches
    s_elig: torch.Tensor          # bool[G, N] node eligible for the spread min
    anti_zone: torch.Tensor       # i32[G, Z] zone totals of anti_zone_cnt
    aff_zone: torch.Tensor        # i32[G, Z] of aff_cnt
    cnt_zone: torch.Tensor        # i32[G, Z] of spread_cnt
    elig_zone: torch.Tensor       # i32[G, Z] of s_elig

    @property
    def max_zones(self) -> int:
        return self.anti_zone.shape[1]

    @property
    def is_con(self) -> torch.Tensor:
        """bool[G]: the group re-places by waves (the reference's is_con)."""
        return (self.s_kind > 0) | (self.a_kind > 0) | self.anti_self_zone

    @property
    def aff2(self) -> torch.Tensor:
        """bool[G]: zone affinity to other pods, which the zone gate needs."""
        return (self.a_kind == 2) & ~self.a_self

    def to(self, device) -> "TopoInputs":
        return TopoInputs(**{k: v.to(device) for k, v in vars(self).items()})


# ------------------------------------------------------- the plain version


def _adjusted(topo: TopoInputs, agg: torch.Tensor, plane: torch.Tensor,
              gi: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """i32[C, Z]: the zone totals `agg` of group gi[k], less what candidate
    c[k] holds in its own zone (`plane[gi, c]`)."""
    zones = torch.arange(topo.max_zones, dtype=topo.zone_cl.dtype,
                         device=agg.device)
    dz = ((zones[None, :] == topo.zone_cl[c][:, None])
          & topo.zone_valid[c][:, None]).to(torch.int32)
    return agg[gi] - dz * plane[gi, c][:, None]


def _at_nodes(topo: TopoInputs, per_zone: torch.Tensor) -> torch.Tensor:
    """[C, Z] → [C, N]: each node's zone's value."""
    return per_zone.gather(
        1, topo.zone_cl.long()[None, :].expand(per_zone.shape[0], -1))


def zone_gate(topo: TopoInputs, gi: torch.Tensor,
              c: torch.Tensor) -> torch.Tensor:
    """bool[C, N]: the zone-level anti-affinity block and non-self zone
    affinity of group gi[k] with candidate c[k] drained."""
    zval = topo.zone_valid[None, :]
    anti = _adjusted(topo, topo.anti_zone, topo.anti_zone_cnt, gi, c)
    aff = _adjusted(topo, topo.aff_zone, topo.aff_cnt, gi, c)
    gate = ~(zval & (_at_nodes(topo, anti) > 0))
    return gate & torch.where(topo.aff2[gi][:, None],
                              zval & (_at_nodes(topo, aff) > 0), True)


def lane_constraints(topo: TopoInputs, gi: torch.Tensor,
                     c: torch.Tensor) -> GroupConstraints:
    """The wave placer's constraints for group gi[k] re-placing the pods of
    candidate c[k], one lane each."""
    n = topo.zone_cl.shape[0]
    node_ids = torch.arange(n, dtype=torch.int32, device=gi.device)
    aff = _adjusted(topo, topo.aff_zone, topo.aff_cnt, gi, c)
    return GroupConstraints(
        s_kind=topo.s_kind[gi], s_skew=topo.s_skew[gi],
        s_self=topo.s_self[gi], s_cnt_node=topo.spread_cnt[gi],
        s_elig=topo.s_elig[gi] & (node_ids[None, :] != c[:, None]),
        a_kind=topo.a_kind[gi], a_self=topo.a_self[gi],
        a_any=topo.a_any[gi],
        a_ok_node=torch.where(
            (topo.a_kind[gi] == 1)[:, None], topo.aff_cnt[gi] > 0,
            topo.zone_valid[None, :] & (_at_nodes(topo, aff) > 0)),
        anti_self_zone=topo.anti_self_zone[gi],
        cnt_zone_base=_adjusted(topo, topo.cnt_zone, topo.spread_cnt, gi, c),
        elig_zone_base=_adjusted(topo, topo.elig_zone, topo.s_elig, gi, c) > 0,
        min_host_base=torch.full(gi.shape, BIG, dtype=torch.int32,
                                 device=gi.device),
        zone_cl=topo.zone_cl[None, :], zone_valid=topo.zone_valid[None, :])


def sweep_plain(inp: SweepInputs, max_groups_per_node: int, explain: bool,
                chunk: int | None = None,
                topo: TopoInputs | None = None) -> tuple:
    """The plain version, chunked over candidates: per chunk, the window
    gather and the compaction, a Python loop over the K slots on a
    [C, N, R] free plane (the cumulative-fit first fit), and the per-pod
    destinations by one `searchsorted` a slot. `topo` makes the re-placement
    topology-aware: each slot's zone gate joins the predicate row, and the
    slot's constrained lanes re-place by waves (the plain wave placer,
    constrained_kernel.place_lanes_plain, on either device) over the first
    fit's result in place."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels.constrained_kernel import (
        place_lanes_plain,
    )

    n = inp.free.shape[0]
    g_total = inp.req.shape[0]
    mpn = inp.mpn
    kk = max_groups_per_node
    dev = inp.free.device
    i32 = torch.int32
    free0, feas_gn, limit_g, dest_ok = (inp.free, inp.feas, inp.limit_one,
                                        inp.dest_ok)
    pad_order, starts = inp.pad_order, inp.starts
    node_ids = torch.arange(n, dtype=i32, device=dev)
    window = torch.arange(mpn, dtype=torch.int64, device=dev)
    slot_k = torch.arange(kk, device=dev)
    group_ids = torch.arange(g_total, dtype=i32, device=dev)

    candidates = inp.candidates
    c_total = int(candidates.shape[0])
    chunk = chunk or default_chunk(c_total, n, free0.shape[1])
    pad_c = max(((c_total + chunk - 1) // chunk) * chunk, chunk)
    cand_pad = torch.cat([candidates.to(i32),
                          torch.zeros((pad_c - c_total,), dtype=i32, device=dev)])

    outs = []
    for c0 in range(0, pad_c, chunk):
        c = cand_pad[c0:c0 + chunk]                                   # [C]
        cn = c.shape[0]
        slots = pad_order[starts[c].long()[:, None] + window[None, :]]  # [C, MPN]
        safe = slots.clamp(min=0).long()
        on_c = ((slots >= 0) & (inp.node_idx[safe] == c[:, None])
                & inp.valid[safe])
        movable = on_c & inp.movable[safe]
        blocker = (on_c & inp.blocks[safe]).any(dim=1)

        # --- compact this node's movable pods into K group slots ---
        gref = torch.where(movable, inp.group_ref[safe], g_total)      # sentinel
        counts = torch.zeros((cn, g_total + 1), dtype=i32, device=dev)
        counts.scatter_add_(1, gref.long(), movable.to(i32))
        nz = counts[:, :g_total] > 0                                   # [C, G]
        rank = torch.cumsum(nz, dim=1) - 1
        compact_of_g = torch.where(nz & (rank < kk), rank, kk)          # [C, G]
        # only the sentinel slot kk can repeat in this scatter, and it is
        # sliced away, so the unspecified order of repeated writes is harmless
        gidx = torch.zeros((cn, kk + 1), dtype=i32, device=dev)
        gidx.scatter_(1, compact_of_g, group_ids.expand(cn, g_total))
        gidx = gidx[:, :kk].long()                                     # [C, K]
        filled = slot_k[None, :] < nz.sum(dim=1).clamp(max=kk)[:, None]
        cnt_k = torch.where(filled, torch.gather(counts[:, :g_total], 1, gidx), 0)

        dest = dest_ok[None, :] & (node_ids[None, :] != c[:, None])    # [C, N]
        if topo is not None:
            # the (candidate, slot) lanes with a wave loop to run, on the
            # device: place_lanes_plain's `active`
            slow = (topo.is_con[gidx] & (cnt_k > 0)).T.contiguous()    # [K, C]
            real = torch.arange(c0, c0 + cn, device=dev) < c_total
            sweep_plain.active_lanes += int((slow & real).sum())

        # --- K-step first-fit of whole groups onto destinations ---
        free_c = free0.expand(cn, n, free0.shape[1])
        placed_k, cumplace_k = [], []
        for j in range(kk):
            gi = gidx[:, j]
            want = cnt_k[:, j]
            reqg = inp.req[gi]                                         # [C, R]
            feas_row = feas_gn[gi] & dest
            if topo is not None:
                feas_row = feas_row & zone_gate(topo, gi, c.long())
            fit = fit_count(free_c, reqg)                              # [C, N]
            fit = torch.where(feas_row, fit, 0)
            fit = torch.where(limit_g[gi][:, None], fit.clamp(max=1), fit)
            fit = torch.minimum(fit, want[:, None])
            cum = torch.cumsum(fit, dim=1)
            place = torch.minimum((want[:, None] - (cum - fit)).clamp(min=0), fit)
            place = place.to(i32)
            new_free = free_c - place[:, :, None] * reqg[:, None, :]
            if topo is not None:
                # the lanes whose group is constrained and has pods re-place
                # by waves, over the first fit's result in place
                place_lanes_plain(free_c, feas_row, reqg, want.contiguous(),
                                  limit_g[gi],
                                  lane_constraints(topo, gi, c.long()),
                                  topo.max_zones, active=slow[j],
                                  out=(new_free, place))
            free_c = new_free
            placed_k.append(place.sum(dim=1))
            cumplace_k.append(torch.cumsum(place, dim=1))
        placed_k = torch.stack(placed_k, dim=1)                        # [C, K]
        if explain:
            outs.append(_explain(blocker, movable, nz, gidx, cnt_k, placed_k,
                                 kk))
            continue
        n_moved = placed_k.sum(dim=1).to(i32)
        n_failed = (movable.sum(dim=1) - n_moved).to(i32)
        drainable = ~blocker & (n_failed == 0)

        # --- per-pod destinations from the placement curves ---
        same = (gref[:, :, None] == gref[:, None, :]) \
            & movable[:, :, None] & movable[:, None, :]
        before = torch.tril(same, -1).sum(dim=2)                       # [C, MPN]
        j_of_slot = torch.gather(
            torch.cat([compact_of_g,
                       torch.full((cn, 1), kk, dtype=compact_of_g.dtype,
                                  device=dev)], dim=1),
            1, gref.long())
        dests = torch.full((cn, mpn), -1, dtype=i32, device=dev)
        for j in range(kk):
            d_j = torch.searchsorted(cumplace_k[j], before + 1).to(i32)
            hit = movable & (j_of_slot == j) & (before < placed_k[:, j][:, None])
            dests = torch.where(hit, d_j, dests)
        pod_slot = torch.where(on_c, safe.to(i32), -1)
        outs.append((drainable, blocker, n_moved, n_failed, dests, pod_slot))

    return tuple(torch.cat(parts)[:c_total] for parts in zip(*outs))


# (candidate, slot) lanes the plain topology-aware sweep has re-placed by
# waves so far (one host read a chunk counts them)
sweep_plain.active_lanes = 0


def _explain(blocker, movable, nz, gidx, cnt_k, placed_k, kk):
    """One chunk's failure attribution: (reason, fail_group, n_unplaced),
    each i32[C]."""
    i32 = torch.int32
    unplaced_k = cnt_k - placed_k                                  # [C, K]
    scan_fail = (unplaced_k > 0).any(dim=1)
    # argmax of a bool row: the first True (0 when none, then unused)
    first_j = (unplaced_k > 0).to(i32).argmax(dim=1)
    fail_group = torch.where(
        scan_fail, torch.gather(gidx, 1, first_j[:, None].long())[:, 0], -1)
    n_unplaced = movable.sum(dim=1) - placed_k.sum(dim=1)
    overflow = nz.sum(dim=1) > kk
    reason = torch.where(
        blocker, DRAIN_BLOCKED_BY_POD,
        torch.where(scan_fail, DRAIN_NO_PLACE_FOR_GROUP,
                    torch.where(overflow, DRAIN_TOO_MANY_SHAPES, DRAIN_OK)))
    return reason.to(i32), fail_group.to(i32), n_unplaced.to(i32)


# ------------------------------------------------------------ the contract

# TopoInputs' fields: (dtype, shape as a function of (n, g, z))
_TOPO = {
    "zone_cl": (I32, lambda n, g, z: (n,)),
    "zone_valid": (torch.bool, lambda n, g, z: (n,)),
    "s_kind": (I32, lambda n, g, z: (g,)),
    "s_skew": (I32, lambda n, g, z: (g,)),
    "s_self": (torch.bool, lambda n, g, z: (g,)),
    "a_kind": (I32, lambda n, g, z: (g,)),
    "a_self": (torch.bool, lambda n, g, z: (g,)),
    "a_any": (torch.bool, lambda n, g, z: (g,)),
    "anti_self_zone": (torch.bool, lambda n, g, z: (g,)),
    "spread_cnt": (I32, lambda n, g, z: (g, n)),
    "aff_cnt": (I32, lambda n, g, z: (g, n)),
    "anti_zone_cnt": (I32, lambda n, g, z: (g, n)),
    "s_elig": (torch.bool, lambda n, g, z: (g, n)),
    "anti_zone": (I32, lambda n, g, z: (g, z)),
    "aff_zone": (I32, lambda n, g, z: (g, z)),
    "cnt_zone": (I32, lambda n, g, z: (g, z)),
    "elig_zone": (I32, lambda n, g, z: (g, z)),
}


def check_inputs(inp: SweepInputs, max_groups_per_node: int,
                 topo: TopoInputs | None = None) -> None:
    """The kernel's input contract, checked on either device: dtypes,
    shapes, one device, contiguity; MPN and K positive; with `topo` its
    fields too, on the same device, at least one zone."""
    dev = inp.free.device
    if inp.free.dim() != 2 or inp.req.dim() != 2 or inp.feas.dim() != 2:
        raise ValueError("free, req and feas must be 2-d")
    n, r = inp.free.shape
    g = inp.req.shape[0]
    p = inp.node_idx.shape[0]
    c = inp.candidates.shape[0]
    mpn = inp.mpn
    if mpn < 1:
        raise ValueError(f"pad_order has {inp.pad_order.shape[0]} places for "
                         f"{p} pods: no window (max_pods_per_node < 1)")
    if max_groups_per_node < 1:
        raise ValueError(f"max_groups_per_node={max_groups_per_node} must be "
                         f"positive")
    _check("candidates", inp.candidates, I32, (c,), dev)
    _check("starts", inp.starts, I32, (n,), dev)
    _check("pad_order", inp.pad_order, I32, (p + mpn,), dev)
    for name in ("node_idx", "group_ref"):
        _check(name, getattr(inp, name), I32, (p,), dev)
    for name in ("valid", "movable", "blocks"):
        _check(name, getattr(inp, name), torch.bool, (p,), dev)
    _check("free", inp.free, I32, (n, r), dev)
    _check("feas", inp.feas, torch.bool, (g, n), dev)
    _check("dest_ok", inp.dest_ok, torch.bool, (n,), dev)
    _check("limit_one", inp.limit_one, torch.bool, (g,), dev)
    _check("req", inp.req, I32, (g, r), dev)
    if topo is None:
        return
    if topo.anti_zone.dim() != 2 or topo.max_zones < 1:
        raise ValueError(f"anti_zone has shape {tuple(topo.anti_zone.shape)}: "
                         f"expected (G, Z) with Z >= 1")
    z = topo.max_zones
    for name, (dtype, shape) in _TOPO.items():
        _check(name, getattr(topo, name), dtype, shape(n, g, z), dev)


# --------------------------------------------------------------- the kernel


@functools.cache
def _lib():
    """The kernel's C entry points, loaded (and built if needed) and typed
    once per process."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels.build import load

    lib = load(SOURCE)
    # every pointer and the stream as c_void_p: ctypes would cut them to int
    lib.ka_drain.argtypes = ([ctypes.POINTER(ctypes.c_void_p)]
                             + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    lib.ka_drain.restype = ctypes.c_int
    lib.ka_drain_threads.argtypes = [ctypes.c_int] * 5
    lib.ka_drain_threads.restype = ctypes.c_int
    return lib


_NODES: dict[torch.device, torch.Tensor] = {}
_WAVES: dict[torch.device, torch.Tensor] = {}


def _counter(store: dict, device, size: int) -> torch.Tensor:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in store:
        store[dev] = torch.zeros((size,), dtype=torch.int64, device=dev)
    return store[dev]


def node_counter(device) -> torch.Tensor:
    """i64[1] on `device`: the destination nodes the first fits of every
    launch needed, added on the card (zero it, run, synchronize, read). A
    slot that places its whole count needs the nodes up to the one where
    its running fit reaches the count; one that does not, every node."""
    return _counter(_NODES, device, 1)


def wave_counter(device) -> torch.Tensor:
    """i64[2] on `device`: the waves (lane-waves) and the (candidate, slot)
    lanes that re-placed by waves in every topology-mode launch, added on
    the card (zero it, run, synchronize, read)."""
    return _counter(_WAVES, device, 2)


def threads(n: int, r: int, mpn: int, kk: int, z: int = 0) -> int:
    """The CTA size of a launch at these widths (`z` zones in the topology
    mode, 0 without) on the current card; raises if its shared memory does
    not fit."""
    t = _lib().ka_drain_threads(n, r, mpn, kk, z)
    if t < 0:
        raise ValueError(f"drain kernel: no launch fits N={n} R={r} MPN={mpn} "
                         f"K={kk} Z={z}")
    return t


def zone_order(topo: TopoInputs) -> tuple[torch.Tensor, torch.Tensor]:
    """(perm, skey), i32[N]: the nodes sorted by zone, keyless nodes (key Z)
    last, node order kept within a zone, and their keys; every candidate's
    waves share them."""
    z = topo.max_zones
    key = torch.where(topo.zone_valid, topo.zone_cl.clamp(0, z - 1), z)
    perm = torch.argsort(key, stable=True)
    return perm.to(I32), key[perm].to(I32)


def launch(inp: SweepInputs, max_groups_per_node: int, explain: bool,
           outs: tuple, topo: TopoInputs | None = None) -> None:
    """One launch on checked CUDA tensors, writing `outs` (the sweep's
    outputs, allocated by the caller): the kernel's C entry runs the fit
    plane's pre-pass into a scratch allocated here, then the sweep. Counted
    in `launch.launches`."""
    n, r = inp.free.shape
    g = inp.req.shape[0]
    dev = inp.free.device
    z = 0 if topo is None else topo.max_zones
    threads(n, r, inp.mpn, max_groups_per_node, z)
    t = dict(vars(inp))
    if explain:
        t["out0"], t["out1"], t["out2"] = outs
    else:
        (t["out0"], t["out1"], t["out2"], t["out3"], t["dest_node"],
         t["pod_slot"]) = outs
    t["nodes"] = node_counter(dev)
    # u16 [G, N rounded up to 8]: the candidate-independent fit plane
    t["fit0"] = torch.empty((g, (n + 7) // 8 * 8), dtype=torch.int16,
                            device=dev) if g else None
    if topo is not None:
        t.update(vars(topo))
        t["perm"], t["skey"] = zone_order(topo)
        t["waves"] = wave_counter(dev)
    ptrs = (ctypes.c_void_p * len(FIELDS))(*[
        t[f].data_ptr() if t.get(f) is not None else None for f in FIELDS])
    rc = _lib().ka_drain(
        ptrs, inp.candidates.shape[0], n, r, g,
        inp.node_idx.shape[0], inp.mpn, max_groups_per_node, z, MAX_WAVES,
        int(explain), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"drain kernel launch failed: CUDA error {rc}")
    launch.launches += 1


launch.launches = 0


def sweep(inp: SweepInputs, max_groups_per_node: int, explain: bool,
          chunk: int | None = None, topo: TopoInputs | None = None) -> tuple:
    """The drain sweep of every candidate: (drainable, has_blocker,
    n_moved, n_failed, dest_node, pod_slot), or with `explain` (reason,
    fail_group, n_unplaced); topology-aware with `topo`. CPU tensors take
    the plain version (chunked by `chunk`), CUDA tensors the kernel: one
    launch for all candidates, none when there is no candidate."""
    check_inputs(inp, max_groups_per_node, topo)
    dev = inp.free.device
    if dev.type == "cpu":
        return sweep_plain(inp, max_groups_per_node, explain, chunk, topo)
    if dev.type != "cuda":
        raise ValueError(f"drain sweep: no kernel for {dev}")
    c = inp.candidates.shape[0]

    def empty(*shape, dtype=I32):
        return torch.empty(shape, dtype=dtype, device=dev)

    if explain:
        outs = (empty(c), empty(c), empty(c))
    else:
        outs = (empty(c, dtype=torch.bool), empty(c, dtype=torch.bool),
                empty(c), empty(c), empty(c, inp.mpn), empty(c, inp.mpn))
    if c:
        with torch.cuda.device(dev):
            launch(inp, max_groups_per_node, explain, outs, topo)
    return outs

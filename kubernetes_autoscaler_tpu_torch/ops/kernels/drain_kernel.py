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
          "out0", "out1", "out2", "out3", "dest_node", "pod_slot", "nodes")


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


# ------------------------------------------------------- the plain version


def sweep_plain(inp: SweepInputs, max_groups_per_node: int, explain: bool,
                chunk: int | None = None, topo=None,
                max_zones: int = 16) -> tuple:
    """The plain version, chunked over candidates: per chunk, the window
    gather and the compaction, a Python loop over the K slots on a
    [C, N, R] free plane (the cumulative-fit first fit), and the per-pod
    destinations by one `searchsorted` a slot. `topo` (ops/drain._Topology)
    makes the re-placement topology-aware: each slot's zone gate joins the
    predicate row, and the slot's constrained lanes re-place by waves
    (ops/constrained.place_lanes) over the first fit's result in place."""
    from kubernetes_autoscaler_tpu_torch.ops.constrained import place_lanes

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
            # device: place_lanes' `active`
            slow = (topo.is_con[gidx] & (cnt_k > 0)).T.contiguous()    # [K, C]

        # --- K-step first-fit of whole groups onto destinations ---
        free_c = free0.expand(cn, n, free0.shape[1])
        placed_k, cumplace_k = [], []
        for j in range(kk):
            gi = gidx[:, j]
            want = cnt_k[:, j]
            reqg = inp.req[gi]                                         # [C, R]
            feas_row = feas_gn[gi] & dest
            if topo is not None:
                feas_row = feas_row & topo.zone_gate(gi, c.long())
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
                place_lanes(free_c, feas_row, reqg, want.contiguous(),
                            limit_g[gi],
                            topo.lane_constraints(gi, c.long()), max_zones,
                            active=slow[j], out=(new_free, place))
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


def check_inputs(inp: SweepInputs, max_groups_per_node: int) -> None:
    """The kernel's input contract, checked on either device: dtypes,
    shapes, one device, contiguity; MPN and K positive."""
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


# --------------------------------------------------------------- the kernel


@functools.cache
def _lib():
    """The kernel's C entry points, loaded (and built if needed) and typed
    once per process."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels.build import load

    lib = load(SOURCE)
    # every pointer and the stream as c_void_p: ctypes would cut them to int
    lib.ka_drain.argtypes = ([ctypes.POINTER(ctypes.c_void_p)]
                             + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.ka_drain.restype = ctypes.c_int
    lib.ka_drain_threads.argtypes = [ctypes.c_int] * 4
    lib.ka_drain_threads.restype = ctypes.c_int
    return lib


_NODES: dict[torch.device, torch.Tensor] = {}


def node_counter(device) -> torch.Tensor:
    """i64[1] on `device`: the destination nodes the first fits of every
    launch needed, added on the card (zero it, run, synchronize, read). A
    slot that places its whole count needs the nodes up to the one where
    its running fit reaches the count; one that does not, every node."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _NODES:
        _NODES[dev] = torch.zeros((1,), dtype=torch.int64, device=dev)
    return _NODES[dev]


def threads(n: int, r: int, mpn: int, kk: int) -> int:
    """The CTA size of a launch at these widths on the current card; raises
    if its shared memory does not fit."""
    t = _lib().ka_drain_threads(n, r, mpn, kk)
    if t < 0:
        raise ValueError(f"drain kernel: no launch fits N={n} R={r} MPN={mpn} "
                         f"K={kk}")
    return t


def launch(inp: SweepInputs, max_groups_per_node: int, explain: bool,
           outs: tuple) -> None:
    """One launch on checked CUDA tensors, writing `outs` (the sweep's
    outputs, allocated by the caller). Counted in `launch.launches`."""
    n, r = inp.free.shape
    dev = inp.free.device
    threads(n, r, inp.mpn, max_groups_per_node)
    t = dict(vars(inp))
    if explain:
        t["out0"], t["out1"], t["out2"] = outs
    else:
        (t["out0"], t["out1"], t["out2"], t["out3"], t["dest_node"],
         t["pod_slot"]) = outs
    t["nodes"] = node_counter(dev)
    ptrs = (ctypes.c_void_p * len(FIELDS))(*[
        t[f].data_ptr() if t.get(f) is not None else None for f in FIELDS])
    rc = _lib().ka_drain(
        ptrs, inp.candidates.shape[0], n, r, inp.req.shape[0],
        inp.node_idx.shape[0], inp.mpn, max_groups_per_node, int(explain),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"drain kernel launch failed: CUDA error {rc}")
    launch.launches += 1


launch.launches = 0


def sweep(inp: SweepInputs, max_groups_per_node: int, explain: bool,
          chunk: int | None = None) -> tuple:
    """The unconstrained drain sweep of every candidate: (drainable,
    has_blocker, n_moved, n_failed, dest_node, pod_slot), or with `explain`
    (reason, fail_group, n_unplaced). CPU tensors take the plain version
    (chunked by `chunk`), CUDA tensors the kernel: one launch for all
    candidates, none when there is no candidate."""
    check_inputs(inp, max_groups_per_node)
    dev = inp.free.device
    if dev.type == "cpu":
        return sweep_plain(inp, max_groups_per_node, explain, chunk)
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
            launch(inp, max_groups_per_node, explain, outs)
    return outs

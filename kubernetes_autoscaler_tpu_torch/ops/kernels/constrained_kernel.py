"""The constrained wave placer: the wrapper of the CUDA kernel and the
plain PyTorch versions.

Replaces the reference package's `ops/constrained.py`
`pack_groups_constrained` (the `lax.scan` over groups, `lax.cond(is_con[g],
slow, fast)`) and `place_group_constrained` (its slow branch, a
`lax.while_loop` of placement waves), under vmap over options; neither is a
Pallas kernel. The kernel is `csrc/constrained.cu`; its header says what
bounds it and how its design answers that (one thread-block cluster a lane
runs every wave of the lane, no host read).

Two entry points, each one launch of the kernel on CUDA tensors and its
plain version on CPU tensors:
- `pack_lanes`: B lanes, each the whole group loop of `order` onto its node
  row: constrained groups by waves, the others by the one-shot first fit.
- `place_lanes`: B lanes, each one group onto its own node row, by waves
  (the kernel's place entry: one group a lane, a cluster a lane as the
  pack runs). `active` (bool[B]) leaves a lane out: its outputs are what
  `out` holds (the input free capacity and no placement when `out` is not
  given). The drain sweep's plain version runs its waves through
  `place_lanes_plain` on either device (the card's reference shares no
  code with the kernel), and the card runs the drain's waves inside the
  drain kernel (csrc/drain.cu).

Every lane input is [L, ...] with L = 1 (a row every lane shares, passed
with lane stride 0, never copied per lane) or B, its trailing dims
contiguous. Anything the kernel does not take raises, on either device.
There is no fallback from the kernel to the plain version.

The plain versions run a Python loop of waves over the lanes at once, a
finished lane frozen with `torch.where` as `while_loop` under `vmap` does,
and read one "any lane active" flag every `ops/constrained.WAVE_CHECK`
waves; `pack_lanes_plain` reads (order, which groups have a wave loop to
run) once a call. `place_lanes.waves` and `place_lanes.flag_reads` count
their waves and reads; the kernel adds each lane's waves to a device
counter (`wave_counter`) and reads nothing.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from kubernetes_autoscaler_tpu_torch.ops import constrained as _con
from kubernetes_autoscaler_tpu_torch.ops.constrained import GroupConstraints
from kubernetes_autoscaler_tpu_torch.ops.kernels.pack_kernel import _check
from kubernetes_autoscaler_tpu_torch.ops.pack import PackResult, fit_count

SOURCE = "constrained.cu"

I32 = torch.int32
BOOL = torch.bool

# csrc/constrained.cu's Field enum, in order
FIELDS = ("free_in", "free_out", "placed", "feas", "req", "want", "limit",
          "order", "s_kind", "s_skew", "s_self", "s_cnt_node",
          "s_elig", "a_kind", "a_self", "a_any", "a_ok_node",
          "anti_self_zone", "cnt_zone_base", "elig_zone_base",
          "min_host_base", "zone_cl", "zone_valid",
          "scratch", "waves", "active")

# the constraint fields: (dtype, trailing dims after the [L, G] lead as a
# function of (n, z))
_CONS = {
    "s_kind": (I32, lambda n, z: ()),
    "s_skew": (I32, lambda n, z: ()),
    "s_self": (BOOL, lambda n, z: ()),
    "s_cnt_node": (I32, lambda n, z: (n,)),
    "s_elig": (BOOL, lambda n, z: (n,)),
    "a_kind": (I32, lambda n, z: ()),
    "a_self": (BOOL, lambda n, z: ()),
    "a_any": (BOOL, lambda n, z: ()),
    "a_ok_node": (BOOL, lambda n, z: (n,)),
    "anti_self_zone": (BOOL, lambda n, z: ()),
    "cnt_zone_base": (I32, lambda n, z: (z,)),
    "elig_zone_base": (BOOL, lambda n, z: (z,)),
    "min_host_base": (I32, lambda n, z: ()),
}


# ------------------------------------------------------- the plain versions


def _zone_segments(zone_cl: torch.Tensor, zone_valid: torch.Tensor,
                   max_zones: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(perm, seg), both i64[B or 1, N]: `perm` orders each row's nodes by
    zone, keyless nodes last, node order kept within a zone; `seg[i]` is the
    position in that order where sorted node i's zone begins."""
    key = torch.where(zone_valid, zone_cl.long(), max_zones)
    perm = torch.argsort(key, dim=1, stable=True)
    skey = key.gather(1, perm).contiguous()
    return perm, torch.searchsorted(skey, skey)


def _waves(free, feas, req, want, limit_one, cons, max_zones):
    """The wave loop over B lanes at once (the reference's
    `place_group_constrained` under vmap); returns (free', place i32[B, N]).
    Reads the "any lane active" flag after every WAVE_CHECK waves (not
    before the first)."""
    b, n = want.shape[0], feas.shape[-1]
    feas = feas.expand(b, n)
    dev = feas.device
    node_ids = torch.arange(n, device=dev)
    perm, seg = _zone_segments(cons.zone_cl, cons.zone_valid, max_zones)
    perm, seg = perm.expand(b, n), seg.expand(b, n)
    zcl = cons.zone_cl.long().expand(b, n)
    zval = cons.zone_valid.expand(b, n)
    zval_i = zval.to(I32)
    big = _con.BIG
    # per-lane constants as columns
    lone = limit_one[:, None]
    a_kind = cons.a_kind[:, None]
    s_self = cons.s_self[:, None]
    skew = cons.s_skew[:, None]
    host_spread = (cons.s_kind == 1)[:, None]
    zone_spread = (cons.s_kind == 2)[:, None]
    anti_zone = cons.anti_self_zone[:, None]
    boot_kind = (cons.a_kind > 0) & cons.a_self & ~cons.a_any      # [B]

    free_c = free
    placed = torch.zeros((b, n), dtype=I32, device=dev)
    rem = want.to(I32)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for wave in range(_con.MAX_WAVES):
        if wave and wave % _con.WAVE_CHECK == 0:
            place_lanes.flag_reads += 1
            if not bool(((rem > 0) & ~done).any()):
                break
        place_lanes.waves += 1
        act = (rem > 0) & ~done
        fit = torch.minimum(fit_count(free_c, req), rem[:, None])
        fit = torch.where(feas, fit, 0)
        fit = torch.where(lone, torch.minimum(1 - (placed > 0).to(I32), fit),
                          fit)

        # --- positive affinity: resident-satisfied, self-opened, or bootstrap
        zone_placed = torch.zeros((b, max_zones), dtype=I32, device=dev)
        zone_placed.scatter_add_(1, zcl, placed * zval_i)             # [B, Z]
        open_zone = zval & (zone_placed.gather(1, zcl) > 0)
        dom_open = torch.where(a_kind == 1, placed > 0, open_zone)
        aff_ok = cons.a_ok_node | (cons.a_self[:, None] & dom_open)
        can = feas & (fit > 0)
        bootstrap = boot_kind & (placed.sum(dim=1) == 0)
        first = can.to(I32).argmax(dim=1)            # the first True, else 0
        boot_mask = (node_ids[None, :] == first[:, None]) \
            & can.any(dim=1)[:, None]
        aff_ok = torch.where(bootstrap[:, None], boot_mask,
                             torch.where(a_kind > 0, aff_ok, True))
        fit = torch.where(aff_ok, fit, 0)

        # --- hostname-domain spread: per-node allowance
        cnt_n = cons.s_cnt_node + torch.where(s_self, placed, 0)
        min_h = torch.minimum(torch.where(cons.s_elig, cnt_n, big).amin(dim=1),
                              cons.min_host_base)
        min_h = torch.where(min_h >= big, 0, min_h)
        allow_h = (min_h[:, None] + skew - cnt_n).clamp(min=0)
        fit = torch.where(host_spread, torch.minimum(fit, allow_h), fit)

        # --- zone-domain caps: spread allowance and/or anti-self 1-per-zone
        cnt_z = cons.cnt_zone_base + torch.where(s_self, zone_placed, 0)
        min_z = torch.where(cons.elig_zone_base, cnt_z, big).amin(dim=1)
        min_z = torch.where(min_z >= big, 0, min_z)
        allow_z = (min_z[:, None] + skew - cnt_z).clamp(min=0)
        zone_cap = torch.where(zone_spread, allow_z, big)
        zone_cap = torch.where(
            anti_zone, torch.minimum(zone_cap, (1 - zone_placed).clamp(min=0)),
            zone_cap)
        # what earlier nodes of the same zone take: an exclusive prefix sum
        # over the zone-ordered nodes, restarted at each zone
        fs = fit.gather(1, perm)
        ex = torch.cumsum(fs, dim=1, dtype=I32) - fs
        ex = ex - ex.gather(1, seg)
        excl = torch.empty_like(ex).scatter_(1, perm, ex)
        capped = (zone_cap.gather(1, zcl) - excl).clamp(min=0)
        # keyless nodes have no zone domain: uncapped by zone constraints
        fit_z = torch.where(zval, torch.minimum(fit, capped), fit)

        # --- global first-fit in node-index order
        cum = torch.cumsum(fit_z, dim=1, dtype=I32)
        place = torch.minimum((rem[:, None] - (cum - fit_z)).clamp(min=0), fit_z)
        place = torch.where(act[:, None], place, 0)
        n_placed = place.sum(dim=1, dtype=I32)
        free_c = free_c - place[:, :, None] * req[:, None, :]
        placed = placed + place
        rem = rem - n_placed
        done = done | (act & (n_placed == 0))
    return free_c, placed


def place_lanes_plain(free, feas, req, want, limit_one, cons, max_zones,
                      active=None, out=None):
    """The plain `place_lanes`. With `active`, one flag read picks the
    active lanes, and only they run the waves."""
    b = want.shape[0]
    if active is None and out is None:
        return _waves(free, feas, req, want, limit_one, cons, max_zones)
    n, r = free.shape[-2:]
    if out is None:
        free_out = torch.empty((b, n, r), dtype=I32, device=free.device)
        free_out.copy_(free.expand(b, n, r))
        out = (free_out, torch.zeros((b, n), dtype=I32, device=free.device))
    if active is None:
        lanes = torch.arange(b, device=free.device)
    else:
        place_lanes.flag_reads += 1
        lanes = active.nonzero().flatten()
        if not lanes.numel():
            return out

    def sel(x):
        return x if x.shape[0] == 1 else x.index_select(0, lanes)

    lf, lp = _waves(sel(free), sel(feas), sel(req), sel(want),
                    sel(limit_one),
                    GroupConstraints(**{k: sel(v) for k, v in vars(cons).items()}),
                    max_zones)
    out[0].index_copy_(0, lanes, lf)
    out[1].index_copy_(0, lanes, lp)
    return out


def _at_group(cons: GroupConstraints, g: int, b: int) -> GroupConstraints:
    """Lane view of group `g` of lane-batched constraints (each field
    [B or 1, G, ...]), expanded to B lanes."""
    fields = {}
    for k, v in vars(cons).items():
        if k in ("zone_cl", "zone_valid"):
            fields[k] = v
        else:
            x = v[:, g]
            fields[k] = x.expand((b,) + tuple(x.shape[1:]))
    return GroupConstraints(**fields)


def pack_lanes_plain(free, mask, req, count, order, limit_one, cons,
                     max_zones) -> PackResult:
    """The plain `pack_lanes`. One read of (order, which groups have a wave
    loop to run, which are constrained on some lane) per call; a group is
    then placed by the one-shot first-fit (ops/pack.pack_groups'
    arithmetic) and, where it is constrained, by the wave placer (nothing
    where its count is not positive), the two joined by a device-side
    select on `is_constrained`."""
    b, n, r = free.shape
    g_total = req.shape[0]
    is_con = cons.is_constrained()                                 # [B|1, G]
    con0 = is_con.any(dim=0)
    order_h, slow_h, con_h = torch.stack(
        [order.to(I32), (con0 & (count > 0)).to(I32), con0.to(I32)]).tolist()
    place_lanes.flag_reads += 1

    free_c = free
    placed = torch.zeros((b, g_total, n), dtype=I32, device=free.device)
    for g in order_h:
        reqg, cnt = req[g], count[g]
        c = fit_count(free_c, reqg)                                 # [B, N]
        c = torch.where(mask[:, g, :], c, 0)
        c = torch.where(limit_one[g], c.clamp(max=1), c)
        c = torch.minimum(c, cnt)
        cum = torch.cumsum(c, dim=1, dtype=I32)
        place = torch.minimum((cnt - (cum - c)).clamp(min=0), c)
        fast_free = free_c - place[:, :, None] * reqg
        if con_h[g]:
            if slow_h[g]:
                slow_free, slow_place = _waves(
                    free_c, mask[:, g, :], reqg.expand(b, r), cnt.expand(b),
                    limit_one[g].expand(b), _at_group(cons, g, b), max_zones)
            else:          # no pod to place: the wave loop runs no wave
                slow_free, slow_place = free_c, torch.zeros_like(place)
            con = is_con[:, g]
            fast_free = torch.where(con[:, None, None], slow_free, fast_free)
            place = torch.where(con[:, None], slow_place, place)
        free_c = fast_free
        placed[:, g, :] = place
    return PackResult(free_after=free_c, placed=placed,
                      scheduled=placed.sum(dim=-1, dtype=I32))


# ------------------------------------------------------------ the contract


def _lane(name: str, t: torch.Tensor, dtype: torch.dtype, b: int,
          trailing: tuple, device: torch.device, shared: bool = True) -> int:
    """Check a lane input [b or 1 (when `shared`), *trailing] and return its
    lane stride in elements: 0 for a row every lane shares (a leading 1, or
    a stride-0 lane axis), else the trailing size (contiguous)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    shape = tuple(t.shape)
    lead = (b, 1) if shared else (b,)
    if len(shape) != 1 + len(trailing) or shape[1:] != tuple(trailing) \
            or shape[0] not in lead:
        want = f"({'|'.join(map(str, lead))}, {', '.join(map(str, trailing))})"
        raise ValueError(f"{name} has shape {shape}, expected {want}")
    stride = 0 if shape[0] == 1 else t.stride(0)
    if stride not in (0, math.prod(trailing)) or \
            (t.numel() and not t[0].is_contiguous()):
        raise ValueError(f"{name} must be contiguous (a shared lane axis "
                         f"may have stride 0)")
    return stride


def _cons_strides(cons: GroupConstraints, b: int, g: int | None, n: int,
                  z: int, dev) -> dict[str, int]:
    """Check every constraint field; their lane strides. `g` is None for
    place_lanes' one group a lane (no group axis)."""
    out = {}
    for k, (dtype, trail) in _CONS.items():
        t = trail(n, z)
        out[k] = _lane(k, getattr(cons, k), dtype, b,
                       t if g is None else (g,) + t, dev)
    out["zone_cl"] = _lane("zone_cl", cons.zone_cl, I32, b, (n,), dev)
    out["zone_valid"] = _lane("zone_valid", cons.zone_valid, BOOL, b, (n,),
                              dev)
    return out


# --------------------------------------------------------------- the kernel


@functools.cache
def _lib():
    """The kernel's C entry points, loaded (and built if needed) and typed
    once per process."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels.build import load

    lib = load(SOURCE)
    lib.ka_constrained.argtypes = (
        [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.ka_constrained.restype = ctypes.c_int
    lib.ka_constrained_place.argtypes = (
        [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.ka_constrained_place.restype = ctypes.c_int
    lib.ka_constrained_config.argtypes = ([ctypes.c_int] * 6
                                          + [ctypes.POINTER(ctypes.c_int)])
    lib.ka_constrained_config.restype = ctypes.c_int
    return lib


_WAVES: dict[torch.device, torch.Tensor] = {}


def wave_counter(device) -> torch.Tensor:
    """i64[1] on `device`: the waves every lane of every launch ran, added on
    the card (zero it, run, synchronize, read)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _WAVES:
        _WAVES[dev] = torch.zeros((1,), dtype=torch.int64, device=dev)
    return _WAVES[dev]


def config(b: int, n: int, r: int, z: int, cluster: int = 0,
           placement: int = 0) -> dict:
    """What a launch of B lanes at (N, R, Z) uses on the current card: the
    cluster size, the threads of a CTA, its dynamic shared memory, whether
    the slices are in shared memory, the nodes of a CTA's slice. `cluster`
    0 lets the kernel choose (1 to 16 forces it); `placement` 0 chooses, 1
    forces device memory, 2 shared memory. Raises if no launch fits."""
    out = (ctypes.c_int * 5)()
    rc = _lib().ka_constrained_config(b, n, r, z, cluster, placement, out)
    if rc != 0:
        raise RuntimeError(f"constrained kernel: no launch fits B={b} N={n} "
                           f"R={r} Z={z} cluster={cluster} placement="
                           f"{placement}: CUDA error {rc}")
    return {"cluster": out[0], "threads": out[1], "smem": out[2],
            "smem_plane": bool(out[3]), "slice": out[4]}


def launch_choice(b: int, n: int, r: int, z: int) -> tuple[int, int]:
    """(cluster, placement) a launch asks `config` for: (0, 0), the
    kernel's choice. Tests replace it to force a cluster size or where the
    slices live."""
    return 0, 0


def launch(b: int, g: int, n: int, r: int, z: int, tensors: dict,
           strides: dict, place: bool = False) -> None:
    """One launch on checked CUDA tensors. `tensors` maps FIELDS names to
    tensors (the inputs, `free_out`, `placed`); the scratch rows and the
    wave counter are added here (each CTA sorts its nodes by zone itself).
    `place` takes the place entry (g = 1, every lane by waves, `active`
    read). Counted in `launches`."""
    dev = tensors["free_out"].device
    cfg = config(b, n, r, z, *launch_choice(b, n, r, z))
    t = dict(tensors)
    t["scratch"] = None if cfg["smem_plane"] else torch.empty(
        (b, 4, n), dtype=I32, device=dev)
    t["waves"] = wave_counter(dev)
    ls = dict(strides)
    ptrs = (ctypes.c_void_p * len(FIELDS))(*[
        t[f].data_ptr() if t.get(f) is not None else None for f in FIELDS])
    lane = (ctypes.c_longlong * len(FIELDS))(*[ls.get(f, 0) for f in FIELDS])
    stream = torch.cuda.current_stream(dev).cuda_stream
    where = 2 if cfg["smem_plane"] else 1
    if place:
        rc = _lib().ka_constrained_place(ptrs, lane, b, n, r, z,
                                         _con.MAX_WAVES, cfg["cluster"],
                                         where, stream)
    else:
        rc = _lib().ka_constrained(ptrs, lane, b, g, n, r, z, _con.MAX_WAVES,
                                   cfg["cluster"], where, stream)
    if rc != 0:
        raise RuntimeError(f"constrained kernel launch failed: CUDA error {rc}")
    launch.launches += 1


launch.launches = 0


def place_lanes(free: torch.Tensor,       # i32[B|1, N, R]
                feas: torch.Tensor,       # bool[B|1, N] full feasibility
                req: torch.Tensor,        # i32[B|1, R]
                want: torch.Tensor,       # i32[B]
                limit_one: torch.Tensor,  # bool[B|1]
                cons: GroupConstraints,   # each field [B|1, ...]
                max_zones: int,
                active: torch.Tensor | None = None,   # bool[B]
                out: tuple | None = None,  # (i32[B, N, R], i32[B, N])
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Wave-greedy placement of B independent lanes, each one group onto
    its own node row; returns (free', place i32[B, N]). The reference's
    `place_group_constrained` under vmap: a lane runs while it has pods
    left and its last wave placed some, for at most MAX_WAVES waves. A lane
    with `active` false is left as `out` holds it (the input capacity and
    no placement without `out`); `out`, when given, is written in place.
    The contract is checked on either device; CPU tensors take the plain
    version, CUDA tensors the kernel's place entry (one launch, no host
    read). `place_lanes.waves` and `place_lanes.flag_reads` count the plain
    versions' waves and host reads."""
    b = want.shape[0]
    dev = want.device
    n, r = feas.shape[-1], free.shape[-1]
    strides = {
        "free_in": _lane("free", free, I32, b, (n, r), dev),
        "feas": _lane("feas", feas, BOOL, b, (n,), dev),
        "req": _lane("req", req, I32, b, (r,), dev),
        "want": _lane("want", want, I32, b, (), dev, shared=False),
        "limit": _lane("limit_one", limit_one, BOOL, b, (), dev),
        **_cons_strides(cons, b, None, n, max_zones, dev)}
    if active is not None:
        _check("active", active, BOOL, (b,), dev)
    if out is not None:
        _check("free_out", out[0], I32, (b, n, r), dev)
        _check("place_out", out[1], I32, (b, n), dev)
    if dev.type == "cpu":
        return place_lanes_plain(free, feas, req, want, limit_one, cons,
                                 max_zones, active=active, out=out)
    if dev.type != "cuda":
        raise ValueError(f"place_lanes: no kernel for {dev}")
    if r < 1 or n < 1:
        raise ValueError(f"place_lanes: N={n}, R={r} must be positive")
    if out is None:
        free_out = torch.empty((b, n, r), dtype=I32, device=dev)
        if active is not None:   # an inactive lane keeps its input capacity
            free_out.copy_(free.expand(b, n, r))
        out = (free_out, torch.zeros((b, n), dtype=I32, device=dev))
    tensors = {"free_in": free, "free_out": out[0], "placed": out[1],
               "feas": feas, "req": req, "want": want, "limit": limit_one,
               "order": torch.zeros((1,), dtype=I32, device=dev),
               "active": active, **vars(cons)}
    with torch.cuda.device(dev):
        launch(b, 1, n, r, max_zones, tensors, strides, place=True)
    return out


place_lanes.waves = 0
place_lanes.flag_reads = 0


def pack_lanes(free: torch.Tensor,       # i32[B, N, R]
               mask: torch.Tensor,       # bool[B|1, G, N] static feasibility
               req: torch.Tensor,        # i32[G, R]
               count: torch.Tensor,      # i32[G]
               order: torch.Tensor,      # i32[G] permutation of 0..G-1
               limit_one: torch.Tensor,  # bool[G]
               cons: GroupConstraints,   # fields [B|1, G, ...], zone [B|1, N]
               max_zones: int) -> PackResult:
    """First-fit-decreasing pack of every group into B independent node
    rows, topology-coupled groups through the wave placer. CPU tensors take
    the plain version, CUDA tensors the kernel (one launch, `order` read on
    the card)."""
    b, n, r = free.shape
    g = req.shape[0]
    dev = free.device
    strides = {
        "free_in": _lane("free", free, I32, b, (n, r), dev),
        "feas": _lane("mask", mask, BOOL, b, (g, n), dev),
        **_cons_strides(cons, b, g, n, max_zones, dev)}
    _check("req", req, I32, (g, r), dev)
    _check("count", count, I32, (g,), dev)
    _check("order", order, I32, (g,), dev)
    _check("limit_one", limit_one, BOOL, (g,), dev)
    if dev.type == "cpu":
        return pack_lanes_plain(free, mask, req, count, order, limit_one,
                                cons, max_zones)
    if dev.type != "cuda":
        raise ValueError(f"pack_lanes: no kernel for {dev}")
    if r < 1 or n < 1:
        raise ValueError(f"pack_lanes: N={n}, R={r} must be positive")
    free_after = torch.empty((b, n, r), dtype=I32, device=dev)
    placed = torch.zeros((b, g, n), dtype=I32, device=dev)
    tensors = {"free_in": free, "free_out": free_after, "placed": placed,
               "feas": mask, "req": req, "want": count, "limit": limit_one,
               "order": order, **vars(cons)}
    with torch.cuda.device(dev):
        launch(b, g, n, r, max_zones, tensors, strides)
    return PackResult(free_after=free_after, placed=placed,
                      scheduled=placed.sum(dim=-1, dtype=I32))

"""The predicate plane: the wrapper of the CUDA kernel and its plain PyTorch
version.

Replaces no Pallas kernel. In the reference package the plane
(`ops/predicates.py`: `_any_eq` :89, `resources_fit` :97, `selector_match`
:103-119, `taints_tolerated` :122-142, `ports_free` :145-152,
`feasibility_mask` :270-288, `reason_mask` :295-325,
`reason_mask_for_groups` :329-341) sits inside jitted programs, where XLA
fuses its loops over the static padding dims into a few loops. Run eagerly,
as the plain version below runs it, every step of those loops is one or
more launches over [G, N] or [G, N, K]: ≈ 570 at the default `Dims()` for
one `feasibility_mask(check_resources=False)`. The kernel,
`csrc/predicates.cu`, computes the same plane in one launch (with the
resident term, one call of its C entry: a memset, a pre-pass and the
plane); its header says what bounds it and how its design answers that.

`plane(nodes, specs, checks, bits, group_mask, scheduled)` is the one entry
that every public function of `ops/predicates.py` calls. `nodes` is anything
with the node planes the checks read (a `NodeTensors`, or a `NodePlanes`
holding only those), `specs` anything with the group planes they read (a
`PodGroupTensors`). `checks` is a bitmask of SELECTOR, TAINTS, PORTS,
RESOURCES and GATES (node valid & ready & schedulable, and the group's
valid flag). The output is bool[G, N], True where no check refuses the pair,
or with `bits` the uint16[G, N] refusal bits of `REASON_*`. Rows whose
`group_mask` entry is False are written 0 in either kind. In the bool kind,
`scheduled` (the resident pods: `valid`, `node_idx`, `group_ref`) also
refuses a self-anti-affine group (`specs.anti_affinity_self`) on a node
where a pod of it runs: the term `filter_pack_inputs` and the drain's
preparation AND into their plane (`resident_group_counts` in the plain
version).

The device of the tensors decides: CPU tensors go through `plane_plain`,
CUDA tensors through the kernel (one call of its C entry, nothing read
back to the host), and an input the kernel does not take raises, on either
device. There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import inspect
from dataclasses import dataclass

import torch

from kubernetes_autoscaler_tpu_torch.models.resources import (
    CPU,
    EPHEMERAL,
    MEMORY,
    NUM_STANDARD,
    PODS,
)

SOURCE = "predicates.cu"

I32 = torch.int32

# the REASON plane's bits (re-exported by ops/predicates.py, which keeps the
# ordered names); csrc/predicates.cu uses the same values
REASON_CPU = 1 << 0           # NodeResourcesFit: cpu request > free
REASON_MEMORY = 1 << 1        # NodeResourcesFit: memory
REASON_EPHEMERAL = 1 << 2     # NodeResourcesFit: ephemeral-storage
REASON_PODS = 1 << 3          # NodeResourcesFit: pod-capacity slot
REASON_EXTENDED = 1 << 4      # NodeResourcesFit: any extended resource (GPU…)
REASON_SELECTOR = 1 << 5      # NodeAffinity / nodeSelector mismatch
REASON_TAINT = 1 << 6         # TaintToleration: uncovered NoSchedule/NoExecute
REASON_PORTS = 1 << 7         # NodePorts: hostPort collision
REASON_NODE_UNAVAILABLE = 1 << 8  # invalid / unready / unschedulable node row
REASON_GROUP_INVALID = 1 << 9     # padding pod-group row (specs.valid False)

# the checks; csrc/predicates.cu's kSelector..kGates
SELECTOR, TAINTS, PORTS, RESOURCES, GATES = 1, 2, 4, 8, 16
ALL_CHECKS = SELECTOR | TAINTS | PORTS | RESOURCES | GATES
STATIC = SELECTOR | TAINTS | PORTS | GATES   # placement-independent

# csrc/predicates.cu's Field enum, in order (its last two, the group mask
# and the output, follow): (owner, name, dtype, widths of its shape)
FIELDS = (
    ("nodes", "label_hash", I32, ("N", "L")),
    ("nodes", "taint_exact", I32, ("N", "T")),
    ("nodes", "taint_key", I32, ("N", "T")),
    ("nodes", "used_ports", I32, ("N", "NP")),
    ("nodes", "valid", torch.bool, ("N",)),
    ("nodes", "ready", torch.bool, ("N",)),
    ("nodes", "schedulable", torch.bool, ("N",)),
    ("nodes", "cap", I32, ("N", "R")),
    ("nodes", "alloc", I32, ("N", "R")),
    ("specs", "sel_req", I32, ("G", "S", "A")),
    ("specs", "sel_neg", I32, ("G", "Sn")),
    ("specs", "tol_exact", I32, ("G", "Tl")),
    ("specs", "tol_key", I32, ("G", "Tl")),
    ("specs", "tolerate_all", torch.bool, ("G",)),
    ("specs", "port_hash", I32, ("G", "PP")),
    ("specs", "valid", torch.bool, ("G",)),
    ("specs", "req", I32, ("G", "R")),
)
# the planes each check reads, as indices into FIELDS
READS = {SELECTOR: (0, 9, 10), TAINTS: (1, 2, 11, 12, 13), PORTS: (3, 14),
         RESOURCES: (7, 8, 16), GATES: (4, 5, 6, 15)}
# the Field enum goes on with the group mask and the output, then the
# resident inputs, then the word plane the pre-pass fills
RESIDENT_FIELDS = (
    ("scheduled", "valid", torch.bool, ("P",)),
    ("scheduled", "node_idx", I32, ("P",)),
    ("scheduled", "group_ref", I32, ("P",)),
    ("specs", "anti_affinity_self", torch.bool, ("G",)),
)
GROUP_MASK, OUT, WORDS = len(FIELDS), len(FIELDS) + 1, len(FIELDS) + 6
NUM_FIELDS = WORDS + 1
# csrc/predicates.cu's Dim enum, in order
DIMS = ("N", "G", "L", "T", "NP", "R", "S", "A", "Sn", "Tl", "PP", "P")
# csrc/predicates.cu's kTile (nodes a CTA) and kMaxChunk (groups a chunk at
# most), and the shared memory a CTA may take on this card
TILE, MAX_CHUNK = 32, 64
MAX_SMEM = 227 * 1024


@dataclass(frozen=True)
class NodePlanes:
    """Some of a NodeTensors' planes: those a check reads, the rest None
    (`selector_match` hands the kernel the label plane alone)."""

    label_hash: torch.Tensor | None = None    # i32[N, L]
    taint_exact: torch.Tensor | None = None   # i32[N, T]
    taint_key: torch.Tensor | None = None     # i32[N, T]
    used_ports: torch.Tensor | None = None    # i32[N, NP]
    valid: torch.Tensor | None = None         # bool[N]
    ready: torch.Tensor | None = None         # bool[N]
    schedulable: torch.Tensor | None = None   # bool[N]
    cap: torch.Tensor | None = None           # i32[N, R]
    alloc: torch.Tensor | None = None         # i32[N, R]

    def free(self) -> torch.Tensor:
        return self.cap - self.alloc


# ---------------------------------------------------------------- plain


def _any_eq(table: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """table: i32[N, K] hash slots, h: i32[G] probes → bool[G, N] membership.

    0 probes never match (0 is the padding sentinel and never a valid hash).
    Builds a G×N×K bool temporary."""
    hit = (table[None, :, :] == h[:, None, None]).any(dim=-1)
    return hit & (h != 0)[:, None]


def resources_fit_plain(nodes, specs) -> torch.Tensor:
    """bool[G, N]: req <= cap - alloc on every resource slot."""
    free = nodes.free()
    return (specs.req[:, None, :] <= free[None, :, :]).all(dim=-1)


def selector_match_plain(node_labels: torch.Tensor, specs) -> torch.Tensor:
    """bool[G, N]: every ANDed requirement has ≥1 alternative present, and no
    must-be-absent hash is present. node_labels: i32[N, L]."""
    g = specs.sel_req.shape[0]
    n = node_labels.shape[0]
    ok = torch.ones((g, n), dtype=torch.bool, device=node_labels.device)
    s_terms, s_alts = specs.sel_req.shape[1], specs.sel_req.shape[2]
    for s in range(s_terms):
        term = specs.sel_req[:, s, :]                      # i32[G, A]
        term_active = (term != 0).any(dim=-1)              # bool[G]
        sat = torch.zeros((g, n), dtype=torch.bool, device=node_labels.device)
        for a in range(s_alts):
            sat = sat | _any_eq(node_labels, term[:, a])
        ok = ok & (~term_active[:, None] | sat)
    for s in range(specs.sel_neg.shape[1]):
        ok = ok & ~_any_eq(node_labels, specs.sel_neg[:, s])
    return ok


def taints_tolerated_plain(taint_exact: torch.Tensor, taint_key: torch.Tensor,
                           specs) -> torch.Tensor:
    """bool[G, N]: every NoSchedule/NoExecute taint is covered by a toleration
    (exact hash = Equal, key hash = Exists, or the tolerate-everything flag).
    taint_exact/taint_key: i32[N, T]."""
    g = specs.tol_exact.shape[0]
    n = taint_exact.shape[0]
    ok = torch.ones((g, n), dtype=torch.bool, device=taint_exact.device)
    for t in range(taint_exact.shape[1]):
        te = taint_exact[:, t]                              # i32[N]
        tk = taint_key[:, t]
        active = te != 0                                    # bool[N]
        covered = specs.tolerate_all[:, None].expand(g, n)
        for tl in range(specs.tol_exact.shape[1]):
            covered = covered | ((specs.tol_exact[:, tl][:, None] == te[None, :])
                                 & active[None, :])
            covered = covered | ((specs.tol_key[:, tl][:, None] == tk[None, :])
                                 & (tk != 0)[None, :])
        ok = ok & (~active[None, :] | covered)
    return ok


def ports_free_plain(used_ports: torch.Tensor, specs) -> torch.Tensor:
    """bool[G, N]: none of the pod's hostPorts collide with occupied ports."""
    g = specs.port_hash.shape[0]
    n = used_ports.shape[0]
    conflict = torch.zeros((g, n), dtype=torch.bool, device=used_ports.device)
    for pp in range(specs.port_hash.shape[1]):
        conflict = conflict | _any_eq(used_ports, specs.port_hash[:, pp])
    return ~conflict


def _bit(fail: torch.Tensor, b: int) -> torch.Tensor:
    return torch.where(fail, b, 0).to(torch.int32)


def _reason_bits(nodes, specs, checks: int) -> torch.Tensor:
    """The refusal bits of `checks` as int32[G, N] (CUDA has no uint16
    bitwise-or)."""
    parts = []
    if checks & SELECTOR:
        parts.append(_bit(~selector_match_plain(nodes.label_hash, specs),
                          REASON_SELECTOR))
    if checks & TAINTS:
        parts.append(_bit(~taints_tolerated_plain(
            nodes.taint_exact, nodes.taint_key, specs), REASON_TAINT))
    if checks & PORTS:
        parts.append(_bit(~ports_free_plain(nodes.used_ports, specs),
                          REASON_PORTS))
    if checks & RESOURCES:
        free = nodes.free()
        lack = specs.req[:, None, :] > free[None, :, :]     # bool[G, N, R]
        parts.append(_bit(lack[..., CPU], REASON_CPU))
        parts.append(_bit(lack[..., MEMORY], REASON_MEMORY))
        parts.append(_bit(lack[..., EPHEMERAL], REASON_EPHEMERAL))
        parts.append(_bit(lack[..., PODS], REASON_PODS))
        parts.append(_bit(lack[..., NUM_STANDARD:].any(dim=-1),
                          REASON_EXTENDED))
    if checks & GATES:
        gate = nodes.valid & nodes.ready & nodes.schedulable
        parts.append(_bit(~gate, REASON_NODE_UNAVAILABLE)[None, :])
        parts.append(_bit(~specs.valid, REASON_GROUP_INVALID)[:, None])
    bits = parts[0]
    for p in parts[1:]:
        bits = bits | p
    return bits


def resident_group_counts(scheduled, g: int, n: int) -> torch.Tensor:
    """i32[G, N]: resident pods of each equivalence group on each node
    (feeds self-anti-affinity masking). The indices are read as the
    reference's `.at[gr, ni].add` reads them: a negative group row counts
    from the end once, and a row or node still outside the plane is
    dropped."""
    ok = scheduled.valid & (scheduled.node_idx >= 0)
    gr = torch.where(ok, scheduled.group_ref, 0).long()
    ni = torch.where(ok, scheduled.node_idx, 0).long()
    gr = torch.where(gr < 0, gr + g, gr)
    keep = ok & (gr >= 0) & (gr < g) & (ni < n)
    out = torch.zeros((g, n), dtype=torch.int32, device=ok.device)
    if g == 0 or n == 0:
        return out
    return out.index_put_((torch.where(keep, gr, 0), torch.where(keep, ni, 0)),
                          keep.to(torch.int32), accumulate=True)


def plane_plain(nodes, specs, checks: int, bits: bool = False,
                group_mask: torch.Tensor | None = None,
                scheduled=None) -> torch.Tensor:
    """The plain version of `plane`, on either device: the reference's
    eager formulation (`feasibility_mask` ANDs the checks' planes,
    `reason_mask` ORs their bits in int32 and casts to uint16; its callers
    AND `~(anti_affinity_self & resident_group_counts > 0)`)."""
    if bits and scheduled is not None:
        raise ValueError("the reason kind takes no resident pods")
    if bits:
        out = _reason_bits(nodes, specs, checks)
        if group_mask is not None:
            out = torch.where(group_mask[:, None], out, 0)
        return out.to(torch.uint16)
    parts = []
    if checks & SELECTOR:
        parts.append(selector_match_plain(nodes.label_hash, specs))
    if checks & TAINTS:
        parts.append(taints_tolerated_plain(nodes.taint_exact,
                                            nodes.taint_key, specs))
    if checks & PORTS:
        parts.append(ports_free_plain(nodes.used_ports, specs))
    if checks & RESOURCES:
        parts.append(resources_fit_plain(nodes, specs))
    if checks & GATES:
        gate = nodes.valid & nodes.ready & nodes.schedulable
        parts += [gate[None, :], specs.valid[:, None]]
    mask = parts[0]
    for p in parts[1:]:
        mask = mask & p
    if group_mask is not None:
        mask = mask & group_mask[:, None]
    if scheduled is not None:
        g, n = mask.shape
        resident = resident_group_counts(scheduled, g, n)
        mask = mask & ~(specs.anti_affinity_self[:, None] & (resident > 0))
    return mask


# ---------------------------------------------------------------- contract


def _read(checks: int) -> list[int]:
    """The indices into FIELDS of the planes `checks` read, in order."""
    return sorted({i for check, idx in READS.items() if checks & check
                   for i in idx})


@functools.cache
def _plan(checks: int) -> tuple:
    """(index, of nodes, name, dtype, widths) of each plane `checks` read,
    in FIELDS order (the order that names each width first)."""
    return tuple((i, FIELDS[i][0] == "nodes", *FIELDS[i][1:])
                 for i in _read(checks))


def _a16(x: int) -> int:
    return (x + 15) & ~15


def _region(nbytes: int) -> int:
    return _a16(nbytes) + 16


def _layout_bytes(d: dict, checks: int, resident: bool, chunk: int) -> int:
    """csrc/predicates.cu's `layout(...).smem` for one chunk size."""
    sel, tai, por, res = (bool(checks & c)
                          for c in (SELECTOR, TAINTS, PORTS, RESOURCES))
    probes = d["S"] * d["A"] + d["Sn"]
    us = chunk * probes if sel else 0
    up = chunk * d["PP"] if por else 0
    ws, wp = ((us + 31) // 32) | 1, ((up + 31) // 32) | 1
    t4, c4 = TILE * 4, chunk * 4
    return sum((
        16,                                                     # mbarriers
        _region(t4 * d["L"]) if sel else 0,
        2 * _region(t4 * d["T"]) if tai else 0,
        _region(t4 * d["NP"]) if por else 0,
        2 * _region(t4 * d["R"]) + _a16(t4 * d["R"]) if res else 0,
        _region(c4 * d["S"] * d["A"]) + _region(c4 * d["Sn"]) if sel else 0,
        2 * _region(c4 * d["Tl"]) if tai else 0,
        _region(c4 * d["PP"]) if por else 0,
        _region(c4 * d["R"]) if res else 0,
        2 * _a16(us * 4) + (_a16(t4 * ws) if sel else 0),       # probes, terms, hits
        _a16(up * 4) + (_a16(t4 * wp) if por else 0),
        _a16(4 * d["S"] * d["A"]) if sel else 0,                # terms of slots
        _a16(4 * d["T"]) + _a16(c4 * d["T"]) if tai else 0,     # taint bits
        _a16(((chunk + 31) // 32 + 1) * t4) if resident else 0,
        _a16(c4 * 8) + 16,                                      # descriptors
        t4))                                                    # node gates


def smem_bytes(d: dict, checks: int, resident: bool = False) -> int:
    """The dynamic shared memory a CTA of the kernel takes (csrc/
    predicates.cu's `fit`) at the widths `check_inputs` gives (0 for a
    check that is off): a tile of TILE nodes' slices, a chunk of groups'
    rows, their compacted probe lists and the nodes' hit rows, at the
    largest chunk (≤ MAX_CHUNK and ≤ G, halving) that fits MAX_SMEM, or
    the one-group chunk's if none does."""
    chunk = min(max(d["G"], 1), MAX_CHUNK)
    need = _layout_bytes(d, checks, resident, chunk)
    while need > MAX_SMEM and chunk > 1:
        chunk = (chunk + 1) // 2
        need = _layout_bytes(d, checks, resident, chunk)
    return need


def _contract(nodes, specs, checks: int, bits: bool, group_mask,
              scheduled) -> tuple[dict, torch.device, list]:
    """`check_inputs` in one pass over the planes read; also returns the
    tensors in the kernel's Field order (None where it reads none)."""
    if not checks or checks & ~ALL_CHECKS:
        raise ValueError(f"checks={checks}: expected a non-empty subset of "
                         f"{ALL_CHECKS}")
    d = dict.fromkeys(DIMS, -1)      # -1: no plane has named the width yet
    ts: list = [None] * NUM_FIELDS
    dev = None
    for i, of_nodes, name, dtype, widths in _plan(checks):
        t = getattr(nodes if of_nodes else specs, name, None)
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{'nodes' if of_nodes else 'specs'}.{name} is "
                             f"needed by checks={checks}")
        dev = _check(("nodes" if of_nodes else "specs", name), t, dtype,
                     widths, d, dev)
        ts[i] = t
    if group_mask is not None:
        _check(("group_mask", ""), group_mask, torch.bool, ("G",), d, dev)
        ts[GROUP_MASK] = group_mask
    if scheduled is not None:
        if bits:
            raise ValueError("the reason kind takes no resident pods")
        for k, (owner, name, dtype, widths) in enumerate(RESIDENT_FIELDS):
            t = getattr(scheduled if owner == "scheduled" else specs, name,
                        None)
            if not isinstance(t, torch.Tensor):
                raise ValueError(f"{owner}.{name} is needed by the resident "
                                 f"term")
            _check((owner, name), t, dtype, widths, d, dev)
            ts[OUT + 1 + k] = t
    for k, w in d.items():
        if w < 0:
            d[k] = 0
    if bits and checks & RESOURCES and d["R"] < NUM_STANDARD:
        raise ValueError(f"the reason kind needs the {NUM_STANDARD} standard "
                         f"resource slots, got R={d['R']}")
    need = smem_bytes(d, checks, scheduled is not None)
    if need > MAX_SMEM:
        raise ValueError(f"widths {d} take {need} B of shared memory a CTA, "
                         f"more than {MAX_SMEM}")
    return d, dev, ts


def check_inputs(nodes, specs, checks: int, bits: bool = False,
                 group_mask: torch.Tensor | None = None, scheduled=None
                 ) -> tuple[dict, torch.device]:
    """The kernel's input contract, checked on either device: known checks,
    the planes they read present with the right dtype and shape, on one
    device, contiguous; the resident pods (valid, node_idx, group_ref [P];
    specs.anti_affinity_self [G]) likewise, and only in the bool kind; the
    reason kind with resources needs the four standard slots; the widths
    within the kernel's shared memory. Returns (widths, device)."""
    d, dev, _ = _contract(nodes, specs, checks, bits, group_mask, scheduled)
    return d, dev


def _check(label: tuple, t: torch.Tensor, dtype: torch.dtype, widths: tuple,
           d: dict, device) -> torch.device:
    """One plane, (owner, name) `label`: on `device` (the first plane's, when
    None), of `dtype`, its shape the widths named so far (the first plane to
    name a width sets it in `d`), contiguous. Returns the device."""
    if device is None:
        device = t.device
    elif t.device != device:
        raise ValueError(f"{_name(label)} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{_name(label)} has dtype {t.dtype}, expected {dtype}")
    shape = t.shape
    if len(shape) != len(widths):
        raise ValueError(f"{_name(label)} has shape {tuple(shape)}, expected "
                         f"{len(widths)} dims {widths}")
    for k, w in zip(widths, shape):
        have = d[k]
        if have < 0:
            d[k] = w
        elif have != w:
            raise ValueError(f"{_name(label)} has shape {tuple(shape)}, "
                             f"expected {tuple(d[x] for x in widths)}")
    if not t.is_contiguous():
        raise ValueError(f"{_name(label)} must be contiguous")
    return device


def _name(label: tuple) -> str:
    return ".".join(x for x in label if x)


# ---------------------------------------------------------------- kernel


@functools.cache
def _entry():
    """The kernel's C entry point, loaded (and built if needed) and typed
    once per process."""
    from kubernetes_autoscaler_tpu_torch.ops.kernels.build import load

    fn = load(SOURCE).ka_pred_plane
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(d: dict, checks: int, bits: bool, tensors: list, stream: int
           ) -> None:
    """One call of the C entry on checked tensors in Field order (`tensors`
    from `_contract`, with the output and, for residents, the word plane
    filled in), enqueued on `stream`. Counted in `launch.launches`."""
    ptrs = (ctypes.c_void_p * NUM_FIELDS)(
        *[None if t is None else t.data_ptr() for t in tensors])
    dims = (ctypes.c_int * len(DIMS))(*[d[k] for k in DIMS])
    rc = _entry()(ptrs, dims, checks, int(bits), stream)
    if rc != 0:
        raise RuntimeError(f"predicate plane launch failed: CUDA error {rc}")
    launch.launches += 1


launch.launches = 0


def plane(nodes, specs, checks: int, bits: bool = False,
          group_mask: torch.Tensor | None = None,
          scheduled=None) -> torch.Tensor:
    """bool[G, N] (no check in `checks` refuses the pair, nor, with the
    resident pods `scheduled`, a resident sibling of a self-anti-affine
    group) or, with `bits`, uint16[G, N] refusal bits; rows outside
    `group_mask` are 0. CPU tensors take the plain version, CUDA tensors
    the kernel: one call of its C entry, none when G or N is 0."""
    d, dev, ts = _contract(nodes, specs, checks, bits, group_mask, scheduled)
    if dev.type == "cpu":
        return plane_plain(nodes, specs, checks, bits, group_mask, scheduled)
    if dev.type != "cuda":
        raise ValueError(f"predicate plane: no kernel for {dev}")
    out = torch.empty((d["G"], d["N"]),
                      dtype=torch.uint16 if bits else torch.bool, device=dev)
    if d["G"] and d["N"]:
        ts[OUT] = out
        if scheduled is not None:
            ts[WORDS] = torch.empty(((d["G"] + 31) // 32) * d["N"],
                                    dtype=torch.int32, device=dev)
        if dev.index == torch.cuda.current_device():
            launch(d, checks, bits, ts, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(dev):
                launch(d, checks, bits, ts,
                       torch.cuda.current_stream().cuda_stream)
    return out


_PLANE_PARAMS = inspect.signature(plane)


def bind_args(*args, **kw) -> tuple:
    """`plane`'s arguments as a caller gives them, in order with the
    defaults filled in: (nodes, specs, checks, bits, group_mask, scheduled).
    For code that wraps `plane` without copying its signature."""
    bound = _PLANE_PARAMS.bind(*args, **kw)
    bound.apply_defaults()
    return tuple(bound.arguments.values())

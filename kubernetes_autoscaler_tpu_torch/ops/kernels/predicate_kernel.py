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
`csrc/predicates.cu`, computes the same plane in one launch; its header
says what bounds it and how its design answers that.

`plane(nodes, specs, checks, bits, group_mask)` is the one entry that every
public function of `ops/predicates.py` calls. `nodes` is anything with the
node planes the checks read (a `NodeTensors`, or a `NodePlanes` holding only
those), `specs` anything with the group planes they read (a
`PodGroupTensors`). `checks` is a bitmask of SELECTOR, TAINTS, PORTS,
RESOURCES and GATES (node valid & ready & schedulable, and the group's
valid flag). The output is bool[G, N], True where no check refuses the pair,
or with `bits` the uint16[G, N] refusal bits of `REASON_*`. Rows whose
`group_mask` entry is False are written 0 in either kind.

The device of the tensors decides: CPU tensors go through `plane_plain`,
CUDA tensors through the kernel (one launch, nothing read back to the
host), and an input the kernel does not take raises, on either device.
There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
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
# csrc/predicates.cu's Dim enum, in order
DIMS = ("N", "G", "L", "T", "NP", "R", "S", "A", "Sn", "Tl", "PP")
# csrc/predicates.cu's kTile (nodes a CTA) and kGroups (groups a CTA), and
# the shared memory a CTA may take on this card
TILE, GROUPS = 128, 8
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


def plane_plain(nodes, specs, checks: int, bits: bool = False,
                group_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of `plane`, on either device: the reference's
    eager formulation (`feasibility_mask` ANDs the checks' planes,
    `reason_mask` ORs their bits in int32 and casts to uint16)."""
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
    return mask


# ---------------------------------------------------------------- contract


def _read(checks: int) -> list[int]:
    """The indices into FIELDS of the planes `checks` read, in order."""
    return sorted({i for check, idx in READS.items() if checks & check
                   for i in idx})


def _dims(nodes, specs, fields: list[int]) -> dict[str, int]:
    """The widths of DIMS from the shapes of the planes read (0 where no
    plane read has it); a plane's rank must be its widths'."""
    d = dict.fromkeys(DIMS, 0)
    for i in fields:
        owner, name, _, widths = FIELDS[i]
        t = getattr(nodes if owner == "nodes" else specs, name)
        if t.dim() != len(widths):
            raise ValueError(f"{owner}.{name} has shape {tuple(t.shape)}, "
                             f"expected {len(widths)} dims {widths}")
        for k, w in zip(widths, t.shape):
            d[k] = d[k] or w
    return d


def smem_bytes(d: dict, checks: int) -> int:
    """The dynamic shared memory a CTA of the kernel takes
    (csrc/predicates.cu's `layout`) at the widths `_dims` gives (0 for a
    check that is off): a node row of the checks' slots at an odd word
    stride, a node, and a group row of the checks' probes and a flags word,
    a group."""
    node = d["L"] + 2 * d["T"] + d["NP"] + d["R"]
    group = 1 + d["S"] * d["A"] + d["Sn"] + 2 * d["Tl"] + d["PP"] + d["R"]
    return (TILE * (node | 1 if node else 0) + GROUPS * group) * 4


def check_inputs(nodes, specs, checks: int, bits: bool = False,
                 group_mask: torch.Tensor | None = None
                 ) -> tuple[dict, torch.device]:
    """The kernel's input contract, checked on either device: known checks,
    the planes they read present with the right dtype and shape, on one
    device, contiguous; the reason kind with resources needs the four
    standard slots; the widths within the kernel's shared memory. Returns
    (widths, device)."""
    if not checks or checks & ~ALL_CHECKS:
        raise ValueError(f"checks={checks}: expected a non-empty subset of "
                         f"{ALL_CHECKS}")
    fields = _read(checks)
    for i in fields:
        owner, name = FIELDS[i][:2]
        if not isinstance(getattr(nodes if owner == "nodes" else specs, name,
                                  None), torch.Tensor):
            raise ValueError(f"{owner}.{name} is needed by checks={checks}")
    d = _dims(nodes, specs, fields)
    dev = None
    for i in fields:
        owner, name, dtype, widths = FIELDS[i]
        t = getattr(nodes if owner == "nodes" else specs, name)
        dev = t.device if dev is None else dev
        _check(f"{owner}.{name}", t, dtype, tuple(d[k] for k in widths), dev)
    if group_mask is not None:
        _check("group_mask", group_mask, torch.bool, (d["G"],), dev)
    if bits and checks & RESOURCES and d["R"] < NUM_STANDARD:
        raise ValueError(f"the reason kind needs the {NUM_STANDARD} standard "
                         f"resource slots, got R={d['R']}")
    if smem_bytes(d, checks) > MAX_SMEM:
        raise ValueError(f"widths {d} take {smem_bytes(d, checks)} B of "
                         f"shared memory a CTA, more than {MAX_SMEM}")
    return d, dev


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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


def launch(nodes, specs, checks: int, bits: bool, group_mask, d: dict,
           out: torch.Tensor) -> None:
    """One launch on checked CUDA tensors, writing `out` (bool or uint16
    [G, N], allocated by the caller). Counted in `launch.launches`."""
    fields = set(_read(checks))
    ptrs = [getattr(nodes if owner == "nodes" else specs, name).data_ptr()
            if i in fields else None
            for i, (owner, name, _, _) in enumerate(FIELDS)]
    ptrs += [None if group_mask is None else group_mask.data_ptr(),
             out.data_ptr()]
    dims = [d[k] for k in DIMS]
    rc = _entry()((ctypes.c_void_p * len(ptrs))(*ptrs),
                  (ctypes.c_int * len(dims))(*dims), checks, int(bits),
                  torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"predicate plane launch failed: CUDA error {rc}")
    launch.launches += 1


launch.launches = 0


def plane(nodes, specs, checks: int, bits: bool = False,
          group_mask: torch.Tensor | None = None) -> torch.Tensor:
    """bool[G, N] (no check in `checks` refuses the pair) or, with `bits`,
    uint16[G, N] refusal bits; rows outside `group_mask` are 0. CPU tensors
    take the plain version, CUDA tensors the kernel: one launch, none when
    G or N is 0."""
    d, dev = check_inputs(nodes, specs, checks, bits, group_mask)
    if dev.type == "cpu":
        return plane_plain(nodes, specs, checks, bits, group_mask)
    if dev.type != "cuda":
        raise ValueError(f"predicate plane: no kernel for {dev}")
    out = torch.empty((d["G"], d["N"]),
                      dtype=torch.uint16 if bits else torch.bool, device=dev)
    if d["G"] and d["N"]:
        with torch.cuda.device(dev):
            launch(nodes, specs, checks, bits, group_mask, d, out)
    return out

"""ctypes binding for the native confirmation pass (kaconfirm.cc in
libkacodec.so) + the planner-facing wrapper.

The native kernel covers the common case AND the constrained tier (zone- and
host-kind topology spread, host/zone required anti-affinity AND required
pod affinity incl. the first-pod exception);
`core/scaledown/planner.py` keeps the Python pass as the general fallback
(lossy encodings, host ports, atomic groups, injected phantoms) and
`tests/test_native_confirm.py` + `tests/test_native_constrained.py`
property-test the two against each other.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from dataclasses import dataclass

import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "sidecar")
_LIB_PATH = os.path.join(_DIR, "libkacodec.so")
_lib = None
_available: bool | None = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        subprocess.run(["make", "-C", _DIR, "-s"], check=True)
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        # a binary built by a different toolchain (e.g. newer libstdc++)
        # fails to load — rebuild once with the local compiler rather than
        # silently abandoning the native tier
        subprocess.run(["make", "-C", _DIR, "-s", "-B"], check=True)
        lib = ctypes.CDLL(_LIB_PATH)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.ka_confirm_c.restype = ctypes.c_int
    lib.ka_confirm_c.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i64p, u8p, u8p, i32p,
        ctypes.c_int, i32p, i32p, i32p, i32p, i32p,
        ctypes.c_int, i32p,
        ctypes.c_void_p, ctypes.c_void_p, i64p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        # constrained tier (20 pointer args after n_zones)
        ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        u8p, u8p, i32p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    global _available
    if _available is None:
        try:
            _load()
            _available = True
        except Exception:
            _available = False
    return _available


@dataclass
class ConstraintBlock:
    """Constrained-tier inputs (see kaconfirm.cc ConState). All arrays are
    C-contiguous; count planes are MUTATED by the kernel."""

    n_zones: int
    zone_id: np.ndarray          # i32[N]
    spread_kind: np.ndarray      # u8[G] (0 none, 1 host, 2 zone)
    max_skew: np.ndarray         # i32[G]
    spread_self: np.ndarray      # u8[G]
    has_anti_host: np.ndarray    # u8[G]
    has_anti_zone: np.ndarray    # u8[G]
    aff_kind: np.ndarray         # u8[G] (0 none, 1 host, 2 zone)
    aff_self: np.ndarray         # u8[G]
    one_per_node: np.ndarray     # u8[G] limit_g (anti-self | host ports)
    oracle_moved: np.ndarray     # u8[G] = need_exact (python oracle-moves)
    elig: np.ndarray             # u8[G, N]
    cnt_node: np.ndarray         # i32[G, N]
    anti_host_node: np.ndarray   # i32[G, N]
    anti_zone_node: np.ndarray   # i32[G, N]
    aff_node: np.ndarray         # i32[G, N]
    m_spread: np.ndarray         # u8[G, G]
    m_anti_h: np.ndarray         # u8[G, G]
    m_anti_z: np.ndarray         # u8[G, G]
    m_aff: np.ndarray            # u8[G, G]
    con_path: np.ndarray         # u8[G]


def _vp(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def confirm(
    free: np.ndarray,            # i64[N, R] — mutated
    feas: np.ndarray,            # bool[G, N]
    node_valid: np.ndarray,      # bool[N]
    greq: np.ndarray,            # i32[G, R]
    cand_node: np.ndarray,       # i32[C]
    slot_ids: np.ndarray,        # i32[total]
    slot_group: np.ndarray,      # i32[total]
    slot_off: np.ndarray,        # i32[C+1]
    cand_group_idx: np.ndarray,  # i32[C]
    group_room: np.ndarray,      # i32[n_room] — mutated
    quota_totals: np.ndarray | None,  # i64[R] — mutated
    quota_min: np.ndarray | None,     # i64[R]
    node_cap: np.ndarray,        # i64[N, R]
    empty_budget: int, drain_budget: int, total_budget: int,
    max_slot_id: int,
    slot_pdb_mask: np.ndarray | None = None,   # u64[max_slot_id+1, words]
    pdb_remaining: np.ndarray | None = None,   # i64[n_pdbs] — mutated
    con: ConstraintBlock | None = None,
):
    """Run the native pass; returns (accept u8[C], reason u8[C], dest i32[S]).
    Reasons: 0 ok, 1 no-place, 2 group-room, 3 quota, 4 budget, 5 pdb."""
    lib = _load()
    n, r = free.shape
    g = feas.shape[0]
    c = cand_node.shape[0]
    accept = np.zeros((c,), np.uint8)
    reason = np.zeros((c,), np.uint8)
    dest = np.full((max_slot_id + 1,), -1, np.int32)
    qt = (quota_totals.ctypes.data_as(ctypes.c_void_p)
          if quota_totals is not None else None)
    qm = (quota_min.ctypes.data_as(ctypes.c_void_p)
          if quota_min is not None else None)
    n_pdbs = int(pdb_remaining.shape[0]) if pdb_remaining is not None else 0
    pdb_words = (n_pdbs + 63) // 64
    sp_arr = None
    if n_pdbs > 0:
        sp_arr = np.ascontiguousarray(slot_pdb_mask, np.uint64)
        if sp_arr.ndim == 1:       # single-word legacy layout
            sp_arr = sp_arr[:, None]
        if sp_arr.shape[1] != pdb_words:
            # a mis-strided mask would read out-of-bounds rows natively —
            # fail fast even under python -O
            raise ValueError(
                f"slot_pdb_mask has {sp_arr.shape[1]} words, "
                f"{pdb_words} needed for {n_pdbs} budgets")
    sp = (sp_arr.ctypes.data_as(ctypes.c_void_p)
          if n_pdbs > 0 else None)
    pr = (pdb_remaining.ctypes.data_as(ctypes.c_void_p)
          if n_pdbs > 0 else None)
    if con is not None:
        con_args = [
            int(con.n_zones), _vp(con.zone_id), _vp(con.spread_kind),
            _vp(con.max_skew), _vp(con.spread_self), _vp(con.has_anti_host),
            _vp(con.has_anti_zone), _vp(con.aff_kind), _vp(con.aff_self),
            _vp(con.one_per_node), _vp(con.oracle_moved),
            _vp(con.elig), _vp(con.cnt_node),
            _vp(con.anti_host_node), _vp(con.anti_zone_node),
            _vp(con.aff_node),
            _vp(con.m_spread), _vp(con.m_anti_h), _vp(con.m_anti_z),
            _vp(con.m_aff), _vp(con.con_path),
        ]
    else:
        con_args = [0] + [None] * 20
    rc = lib.ka_confirm_c(
        n, r, g,
        np.ascontiguousarray(free),
        np.ascontiguousarray(feas.astype(np.uint8)),
        np.ascontiguousarray(node_valid.astype(np.uint8)),
        np.ascontiguousarray(greq.astype(np.int32)),
        c,
        np.ascontiguousarray(cand_node.astype(np.int32)),
        np.ascontiguousarray(slot_ids.astype(np.int32)),
        np.ascontiguousarray(slot_group.astype(np.int32)),
        np.ascontiguousarray(slot_off.astype(np.int32)),
        np.ascontiguousarray(cand_group_idx.astype(np.int32)),
        int(group_room.shape[0]),
        group_room,
        qt, qm,
        np.ascontiguousarray(node_cap.astype(np.int64)),
        int(empty_budget), int(drain_budget), int(total_budget),
        n_pdbs, pdb_words, sp, pr,
        *con_args,
        accept, reason, dest,
    )
    if rc < 0:
        raise RuntimeError("ka_confirm rejected its arguments")
    return accept, reason, dest

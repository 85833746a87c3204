"""ctypes bindings for the native snapshot-delta codec (the port's own
csrc/host/kacodec.cc, a copy of the reference package's
sidecar/native/kacodec.cc).

The library builds on first use with the host compiler through
ops/kernels/build.build_host into `_build/` (no pip deps); a build failure
raises with the compiler's output — callers gate on `available()`. The
numpy exports are the reference's, byte for byte; `to_tensors` puts them on
an explicit device.
"""

from __future__ import annotations

import ctypes

import numpy as np

from kubernetes_autoscaler_tpu_torch.models import resources as res
from kubernetes_autoscaler_tpu_torch.models.cluster_state import DEFAULT_DIMS, Dims

SOURCE = "kacodec.cc"
_lib = None


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    from kubernetes_autoscaler_tpu_torch.ops.kernels.build import build_host

    try:
        lib = ctypes.CDLL(str(build_host(SOURCE)))
    except OSError:
        # stale binary from a different toolchain (loader version mismatch):
        # force-rebuild with the local compiler, then load for real
        lib = ctypes.CDLL(str(build_host(SOURCE, force=True)))
    lib.ka_state_new.restype = ctypes.c_void_p
    lib.ka_state_new.argtypes = [ctypes.c_int] * 8
    lib.ka_state_free.argtypes = [ctypes.c_void_p]
    lib.ka_last_error.restype = ctypes.c_char_p
    lib.ka_last_error.argtypes = [ctypes.c_void_p]
    lib.ka_apply_delta.restype = ctypes.c_int
    lib.ka_apply_delta.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint64]
    lib.ka_version.restype = ctypes.c_uint64
    lib.ka_version.argtypes = [ctypes.c_void_p]
    try:
        # per-export-section versions (plane-granular cache keys); absent
        # on a stale pre-ISSUE-11 binary — section_versions() degrades to
        # the whole-state version, which only costs cache granularity
        lib.ka_section_version.restype = ctypes.c_uint64
        lib.ka_section_version.argtypes = [ctypes.c_void_p, ctypes.c_int]
    except AttributeError:  # pragma: no cover — repo ships the new binary
        pass
    for f in (lib.ka_num_nodes, lib.ka_num_pods, lib.ka_num_groups):
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p]
    lib.ka_export_nodes.restype = ctypes.c_int
    lib.ka_export_groups.restype = ctypes.c_int
    lib.ka_export_pods.restype = ctypes.c_int
    lib.ka_group_key.restype = ctypes.c_int
    lib.ka_group_key.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_char_p, ctypes.c_int]
    lib.ka_node_row.restype = ctypes.c_int
    lib.ka_node_row.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ka_zone_id.restype = ctypes.c_int
    lib.ka_zone_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ka_num_zones.restype = ctypes.c_int
    lib.ka_num_zones.argtypes = [ctypes.c_void_p]
    lib.ka_fold32_batch.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64), ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32),
    ]
    lib.ka_fnv64_batch.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64), ctypes.c_int,
        np.ctypeslib.ndpointer(np.int64),
    ]
    _lib = lib
    return lib


def available() -> bool:
    try:
        load()
        return True
    except Exception:
        return False


def fold32_batch(strings: list[bytes]) -> np.ndarray:
    """Native batch hashing (hot path of models/encode for big clusters)."""
    lib = load()
    data = b"".join(strings)
    offsets = np.zeros(len(strings) + 1, np.int64)
    np.cumsum([len(s) for s in strings], out=offsets[1:])
    out = np.zeros(len(strings), np.int32)
    lib.ka_fold32_batch(data, offsets, len(strings), out)
    return out


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeSnapshotState:
    """Server-side incremental cluster state (the sidecar's resident model)."""

    def __init__(self, dims: Dims = DEFAULT_DIMS):
        self.lib = load()
        self.dims = dims
        self.handle = ctypes.c_void_p(self.lib.ka_state_new(
            dims.max_labels, dims.max_taints, dims.max_tolerations,
            dims.max_sel_terms, dims.max_sel_alts, dims.max_neg_terms,
            dims.max_pod_ports, dims.max_node_ports,
        ))

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.ka_state_free(self.handle)
            self.handle = None

    def apply_delta(self, payload: bytes) -> None:
        rc = self.lib.ka_apply_delta(self.handle, payload, len(payload))
        if rc != 0:
            err = self.lib.ka_last_error(self.handle).decode()
            raise ValueError(f"apply_delta failed rc={rc}: {err}")

    @property
    def version(self) -> int:
        return int(self.lib.ka_version(self.handle))

    def counts(self) -> tuple[int, int, int]:
        return (self.lib.ka_num_nodes(self.handle),
                self.lib.ka_num_pods(self.handle),
                self.lib.ka_num_groups(self.handle))

    def group_key(self, row: int) -> str:
        """Equivalence key of a group row ('' when out of range) — the join
        key for the KAUX constraint side-channel (sidecar/constraints.py)."""
        buf = ctypes.create_string_buffer(256)
        n = self.lib.ka_group_key(self.handle, row, buf, 256)
        if n < 0:
            return ""
        return buf.raw[: min(n, 256)].decode()

    def node_row(self, name: str) -> int:
        return int(self.lib.ka_node_row(self.handle, name.encode()))

    def zone_id(self, zone: str) -> int:
        """Codec-interned id for a zone string (-1 = unknown, 0 = none)."""
        return int(self.lib.ka_zone_id(self.handle, zone.encode()))

    def num_zones(self) -> int:
        return int(self.lib.ka_num_zones(self.handle))

    def zone_table_for_templates(self, zones: list[str]):
        """A ZoneTable aligned with the codec's zone-id space: known zones
        reuse the codec's ids; unknown template zones get fresh ids beyond
        them (review finding: a fresh ZoneTable would intern template zones
        in a DIFFERENT id space than the exported node tensors)."""
        from kubernetes_autoscaler_tpu_torch.models.encode import ZoneTable

        ids: dict[str, int] = {}
        next_id = self.num_zones() + 1
        for z in zones:
            if not z or z in ids:
                continue
            known = self.zone_id(z)
            if known > 0:
                ids[z] = known
            else:
                ids[z] = next_id
                next_id += 1
        return ZoneTable(ids=ids)

    def section_versions(self) -> tuple[int, int, int]:
        """(nodes, groups, pods) export-section versions — the codec bumps
        exactly the sections a delta's ops could change, so these are the
        plane-granular cache keys (server._Tenant export/device caches). A
        stale binary without the symbol degrades to the whole-state version
        on every axis (correct, just coarser caching)."""
        fn = getattr(self.lib, "ka_section_version", None)
        if fn is None:  # pragma: no cover — repo ships the new binary
            v = self.version
            return (v, v, v)
        return (int(fn(self.handle, 0)), int(fn(self.handle, 1)),
                int(fn(self.handle, 2)))

    def export_nodes(self, node_bucket: int = 64) -> dict:
        """Node tensor section at `pad_to(n, node_bucket)` rows (numpy)."""
        from kubernetes_autoscaler_tpu_torch.models.cluster_state import pad_to

        d = self.dims
        n, _, _ = self.counts()
        n_pad = pad_to(n, node_bucket)
        r = res.NUM_RESOURCES
        nodes = {
            "cap": np.zeros((n_pad, r), np.int32),
            "alloc": np.zeros((n_pad, r), np.int32),
            "label_hash": np.zeros((n_pad, d.max_labels), np.int32),
            "taint_exact": np.zeros((n_pad, d.max_taints), np.int32),
            "taint_key": np.zeros((n_pad, d.max_taints), np.int32),
            "used_ports": np.zeros((n_pad, d.max_node_ports), np.int32),
            "zone_id": np.zeros((n_pad,), np.int32),
            "group_id": np.full((n_pad,), -1, np.int32),
            "ready": np.zeros((n_pad,), np.uint8),
            "schedulable": np.zeros((n_pad,), np.uint8),
            "valid": np.zeros((n_pad,), np.uint8),
        }
        rc = self.lib.ka_export_nodes(
            self.handle, n_pad, _ptr(nodes["cap"]), _ptr(nodes["alloc"]),
            _ptr(nodes["label_hash"]), _ptr(nodes["taint_exact"]),
            _ptr(nodes["taint_key"]), _ptr(nodes["used_ports"]),
            _ptr(nodes["zone_id"]), _ptr(nodes["group_id"]),
            _ptr(nodes["ready"]), _ptr(nodes["schedulable"]),
            _ptr(nodes["valid"]))
        if rc < 0:
            raise ValueError(f"export_nodes failed rc={rc}")
        return nodes

    def export_groups(self, group_bucket: int = 64) -> dict:
        """Pod-group tensor section at `pad_to(max(g, 1), group_bucket)`."""
        from kubernetes_autoscaler_tpu_torch.models.cluster_state import pad_to

        d = self.dims
        _, _, g = self.counts()
        g_pad = pad_to(max(g, 1), group_bucket)
        r = res.NUM_RESOURCES
        groups = {
            "req": np.zeros((g_pad, r), np.int32),
            "count": np.zeros((g_pad,), np.int32),
            "sel_req": np.zeros((g_pad, d.max_sel_terms, d.max_sel_alts), np.int32),
            "sel_neg": np.zeros((g_pad, d.max_neg_terms), np.int32),
            "tol_exact": np.zeros((g_pad, d.max_tolerations), np.int32),
            "tol_key": np.zeros((g_pad, d.max_tolerations), np.int32),
            "tolerate_all": np.zeros((g_pad,), np.uint8),
            "port_hash": np.zeros((g_pad, d.max_pod_ports), np.int32),
            "anti_self": np.zeros((g_pad,), np.uint8),
            "valid": np.zeros((g_pad,), np.uint8),
            "lossy": np.zeros((g_pad,), np.uint8),
        }
        rc = self.lib.ka_export_groups(
            self.handle, g_pad, _ptr(groups["req"]), _ptr(groups["count"]),
            _ptr(groups["sel_req"]), _ptr(groups["sel_neg"]),
            _ptr(groups["tol_exact"]), _ptr(groups["tol_key"]),
            _ptr(groups["tolerate_all"]), _ptr(groups["port_hash"]),
            _ptr(groups["anti_self"]), _ptr(groups["valid"]),
            _ptr(groups["lossy"]))
        if rc < 0:
            raise ValueError(f"export_groups failed rc={rc}")
        return groups

    def export_pods(self, pod_bucket: int = 256) -> dict:
        """Scheduled-pod tensor section at `pad_to(p, pod_bucket)`."""
        from kubernetes_autoscaler_tpu_torch.models.cluster_state import pad_to

        _, p, _ = self.counts()
        p_pad = pad_to(p, pod_bucket)
        r = res.NUM_RESOURCES
        pods = {
            "req": np.zeros((p_pad, r), np.int32),
            "node_idx": np.full((p_pad,), -1, np.int32),
            "group_ref": np.zeros((p_pad,), np.int32),
            "movable": np.zeros((p_pad,), np.uint8),
            "blocks": np.zeros((p_pad,), np.uint8),
            "valid": np.zeros((p_pad,), np.uint8),
        }
        rc = self.lib.ka_export_pods(
            self.handle, p_pad, _ptr(pods["req"]), _ptr(pods["node_idx"]),
            _ptr(pods["group_ref"]), _ptr(pods["movable"]),
            _ptr(pods["blocks"]), _ptr(pods["valid"]))
        if rc < 0:
            raise ValueError(f"export_pods failed rc={rc}")
        return pods

    def export(self, node_bucket: int = 64, group_bucket: int = 64,
               pod_bucket: int = 256):
        """Materialize tensors (numpy; caller ships to device). Mirrors the
        EncodedCluster tensor layout exactly. Per-section callers (the
        plane-granular export cache) use export_nodes/export_groups/
        export_pods directly."""
        return (self.export_nodes(node_bucket),
                self.export_groups(group_bucket),
                self.export_pods(pod_bucket))

    def to_tensors(self, node_bucket: int = 64, group_bucket: int = 64,
                   pod_bucket: int = 256, device=None):
        """Export as NodeTensors/PodGroupTensors/ScheduledPodTensors on
        `device` (None = CUDA, raising without it)."""
        from kubernetes_autoscaler_tpu_torch.sidecar.batch import (
            node_tensors,
            podgroup_tensors,
            sched_tensors,
        )

        nodes, groups, pods = self.export(node_bucket, group_bucket, pod_bucket)
        return (node_tensors(nodes, device), podgroup_tensors(groups, device),
                sched_tensors(pods, device))

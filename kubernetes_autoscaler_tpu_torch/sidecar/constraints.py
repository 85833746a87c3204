"""Constraint overlay for sidecar-fed snapshots.

The KAD1 dense rows (C++ codec) cannot carry topology-coupled specs; the wire
ships them on the KAUX trailer (`sidecar/wire.py`). This module rebuilds what
`models/encode.encode_cluster` derives natively — per-group constraint
scalars + resident-count AffinityPlanes — on top of the C++-exported tensors,
so a Go-fed cluster gets the device constrained tier (ops/constrained.py)
instead of blanket host-checking every constrained pod. The overlay is
built on the host and lands on the device of the exported specs.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_autoscaler_tpu_torch.models.api import (
    HOSTNAME_KEY,
    ZONE_KEY,
    ZONE_KEY_BETA,
    labels_match,
)
from kubernetes_autoscaler_tpu_torch.models.cluster_state import AffinityPlanes
from kubernetes_autoscaler_tpu_torch.ops.hostfetch import to_host


def _kind(topology_key: str) -> int:
    if topology_key == HOSTNAME_KEY:
        return 1
    if topology_key in (ZONE_KEY, ZONE_KEY_BETA):
        return 2
    return 0


def _term_matches(sel: dict, namespaces: list[str], own_ns: str,
                  other_ns: str, other_labels: dict) -> bool:
    nss = namespaces or [own_ns]
    return other_ns in nss and labels_match(sel, other_labels)


def attach_constraints(state, specs, n_nodes: int, aux: dict[str, dict],
                       max_zones: int = 16):
    """(specs', planes, has_constraints) from the aux records.

    `state` is a NativeSnapshotState (needs group_key(row) and node_row(name));
    `specs` the exported PodGroupTensors; aux maps pod uid -> wire record.
    """
    # zones_fit guard (mirrors encode_cluster): the codec's zone ids are
    # unbounded; when they exceed the static Z dim the kernels would ALIAS
    # distinct zones, so zone-kind constraints must fall back to host-check
    zones_fit = state.num_zones() + 1 <= max_zones
    g_pad = specs.g
    row_of: dict[str, int] = {}
    for r in range(g_pad):
        key = state.group_key(r)
        if key:
            row_of[key] = r

    spread_kind = np.zeros((g_pad,), np.int32)
    max_skew = np.zeros((g_pad,), np.int32)
    spread_self = np.zeros((g_pad,), bool)
    aff_kind = np.zeros((g_pad,), np.int32)
    aff_self = np.zeros((g_pad,), bool)
    anti_self_zone = np.zeros((g_pad,), bool)
    anti_self_host = to_host(specs.anti_affinity_self).copy()
    lossy = to_host(specs.needs_host_check).copy()

    # exemplar constraint specs per row (first constrained record wins)
    row_spec: dict[int, dict] = {}
    constrained = False
    for rec in aux.values():
        if not (rec.get("s") or rec.get("a") or rec.get("x")):
            continue
        row = row_of.get(rec.get("k", ""))
        if row is None or row in row_spec:
            continue
        row_spec[row] = rec
        exotic = False
        s = rec.get("s")
        if s:
            k = _kind(s["key"])
            if k == 2 and not zones_fit:
                k = 0
            # the dense tier models the DEFAULT inclusion policies and
            # minDomains=1 only; non-defaults go to the exact host tier
            # (mirrors models/encode._encode_pod_spec)
            nondefault = (int(s.get("md", 1)) > 1
                          or s.get("nap", "Honor") == "Ignore"
                          or s.get("ntp", "Ignore") == "Honor")
            if k and not s.get("extra") and not nondefault:
                spread_kind[row] = k
                max_skew[row] = max(int(s["w"]), 1)
                spread_self[row] = labels_match(s["sel"], rec["l"])
            else:
                exotic = True
        a = rec.get("a")
        if a:
            k = _kind(a["key"])
            if k == 2 and not zones_fit:
                k = 0
            if a.get("nssel") is not None:
                k = 0  # namespace-by-labels scoping → exact host tier
            if k and not a.get("extra"):
                aff_kind[row] = k
                aff_self[row] = _term_matches(
                    a["sel"], a.get("nss", []), rec["ns"], rec["ns"], rec["l"])
            else:
                exotic = True
        for t in rec.get("x", []):
            k = _kind(t["key"])
            if k == 2 and not zones_fit:
                k = 0
            if t.get("nssel") is not None:
                k = 0  # namespace-by-labels scoping → exact host tier
            if k == 0:
                exotic = True
                continue
            self_m = _term_matches(t["sel"], t.get("nss", []), rec["ns"],
                                   rec["ns"], rec["l"])
            if k == 1:
                anti_self_host[row] |= self_m
            else:
                anti_self_zone[row] |= self_m
        if exotic:
            lossy[row] = True
        else:
            constrained = True
            if rec.get("dok"):
                # topology was the only reason the wire flagged lossy, and
                # the overlay now models it — the device tier is exact here
                # (cross-group coupling may re-flag below)
                lossy[row] = False

    if not row_spec:
        return specs, None, False

    # cross-group coupling (mirror encode_cluster): a constrained PENDING
    # row whose selector matches another pending record stays host-checked
    pending = [r for r in aux.values() if not r.get("n")]
    for row, rec in row_spec.items():
        sels: list[tuple[dict, list[str]]] = []
        if rec.get("s") and spread_kind[row]:
            sels.append((rec["s"]["sel"], [rec["ns"]]))
        for t in rec.get("x", []):
            sels.append((t["sel"], t.get("nss", []) or [rec["ns"]]))
        a = rec.get("a")
        if a and aff_kind[row] and not aff_self[row]:
            sels.append((a["sel"], a.get("nss", []) or [rec["ns"]]))
        for other in pending:
            # siblings of the SAME equivalence group are the group's own
            # placements — modeled on device (spread_self/anti caps), not a
            # cross-group coupling (mirrors encode_cluster's hrow != grow)
            if other is rec or other.get("k") == rec.get("k"):
                continue
            if any(other["ns"] in nss and labels_match(sel, other["l"])
                   for sel, nss in sels):
                lossy[row] = True
                break

    # resident-count planes
    p_aff = np.zeros((g_pad, n_nodes), np.int32)
    p_anti_h = np.zeros((g_pad, n_nodes), np.int32)
    p_anti_z = np.zeros((g_pad, n_nodes), np.int32)
    p_spread = np.zeros((g_pad, n_nodes), np.int32)
    for rec in aux.values():
        name = rec.get("n")
        if not name:
            continue
        ni = state.node_row(name)
        if ni < 0 or ni >= n_nodes:
            continue
        for row, spec in row_spec.items():
            a = spec.get("a")
            if a and aff_kind[row] and _term_matches(
                    a["sel"], a.get("nss", []), spec["ns"], rec["ns"], rec["l"]):
                p_aff[row, ni] += 1
            for t in spec.get("x", []):
                k = _kind(t["key"])
                if k and _term_matches(t["sel"], t.get("nss", []), spec["ns"],
                                       rec["ns"], rec["l"]):
                    if k == 1:
                        p_anti_h[row, ni] += 1
                    else:
                        p_anti_z[row, ni] += 1
            s = spec.get("s")
            if (s and spread_kind[row] and rec["ns"] == spec["ns"]
                    and labels_match(s["sel"], rec["l"])):
                p_spread[row, ni] += 1

    dev = specs.req.device

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    specs = specs.replace(
        spread_kind=up(spread_kind),
        max_skew=up(max_skew),
        spread_self=up(spread_self),
        aff_kind=up(aff_kind),
        aff_self=up(aff_self),
        aff_match_any=up(p_aff.sum(axis=1) > 0),
        anti_self_zone=up(anti_self_zone),
        anti_affinity_self=up(anti_self_host),
        needs_host_check=up(lossy),
    )
    planes = AffinityPlanes(
        aff_cnt=up(p_aff),
        anti_host_cnt=up(p_anti_h),
        anti_zone_cnt=up(p_anti_z),
        spread_cnt=up(p_spread),
    )
    return specs, planes, constrained

"""What-if reporting: per-lane summaries, deltas against the null
hypothesis, and the decision-plane digests that pin lane determinism.

Everything here is host-side post-processing of fetched arrays — no device
work. Digests use the journal's canonical sha256 (replay/journal.py) so a
lane digest from a what-if report can be compared 1:1 against a live
loop's journaled verdict surface.
"""

from __future__ import annotations

import hashlib
from typing import Any

import numpy as np


def _digest(*arrays: np.ndarray) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.asarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def lane_digests(decision, real: int) -> list[str]:
    """Per-lane digest over the full decision surface (verdict, pending,
    options, drain planes) — byte-level lane identity in one string."""
    verdict = np.asarray(decision.verdict)
    pending = np.asarray(decision.pending_after)
    est = np.asarray(decision.est_node_count)
    drain = np.asarray(decision.drainable)
    util = np.asarray(decision.util)
    return [_digest(verdict[b], pending[b], est[b], drain[b], util[b])
            for b in range(real)]


def trajectory_digests(traj, real: int) -> list[str]:
    """Per-lane digest of a rollout's decision trajectory (verdict +
    pending planes over T) — what the null-lane identity gate compares
    against T live fused loops."""
    verdict = np.asarray(traj.verdict)
    pending = np.asarray(traj.pending_after)
    return [_digest(verdict[b], pending[b]) for b in range(real)]


def _lane_row(summary, b: int) -> dict[str, Any]:
    return {
        "scaleupCost": float(np.asarray(summary.scaleup_cost)[b]),
        "fleetPrice": float(np.asarray(summary.fleet_price)[b]),
        "utilization": float(np.asarray(summary.utilization)[b]),
        "disruption": int(np.asarray(summary.disruption)[b]),
        "pending": int(np.asarray(summary.pending)[b]),
        "nodesAdded": int(np.asarray(summary.nodes_added)[b]),
        "best": int(np.asarray(summary.best)[b]),
    }


def build_report(lanes, summary=None, decision=None, traj=None,
                 workload=None) -> dict[str, Any]:
    """The what-if product surface: one JSON-able dict. Lane 0 is the null
    hypothesis; every other lane carries absolute values AND deltas vs
    lane 0. Padding lanes (shape-class rung fill) are excluded."""
    real = lanes.real
    out: dict[str, Any] = {
        "lanes": real,
        "meta": dict(lanes.meta),
        "variants": [v.to_dict() for v in lanes.variants[:real]],
    }
    if workload is not None:
        out["workload"] = workload.to_record()
    if summary is not None:
        rows = [_lane_row(summary, b) for b in range(real)]
        null = rows[0]
        for row in rows:
            row["deltas"] = {
                "scaleupCost": row["scaleupCost"] - null["scaleupCost"],
                "fleetPrice": row["fleetPrice"] - null["fleetPrice"],
                "utilization": row["utilization"] - null["utilization"],
                "disruption": row["disruption"] - null["disruption"],
                "pending": row["pending"] - null["pending"],
            }
        out["summary"] = rows
    if decision is not None:
        out["laneDigests"] = lane_digests(decision, real)
    if traj is not None:
        verdict = np.asarray(traj.verdict)
        out["rollout"] = {
            "steps": int(verdict.shape[1]),
            "trajectoryDigests": trajectory_digests(traj, real),
            "perLane": [{
                "nodesAdded": int(np.asarray(traj.nodes_added)[b].sum()),
                "nodesRemoved": int(np.asarray(traj.nodes_removed)[b].sum()),
                "scaleupCost": float(np.asarray(traj.scaleup_cost)[b].sum()),
                "finalFleetPrice": float(
                    np.asarray(traj.fleet_price)[b, -1]),
                "meanUtil": float(np.asarray(traj.util_mean)[b].mean()),
                "pendingEnd": int(
                    np.asarray(traj.pending_after)[b, -1].sum()),
            } for b in range(real)],
        }
    return out

"""Stacked-world plumbing for batched multi-tenant dispatch.

The port's counterpart of the reference package's sidecar/batch.py. The
sidecar's batching layer (docs/SERVING.md) turns one coalescing window's
tickets into ONE batched dispatch per shape class
(ops/autoscale_step.scale_up_sim_batch / scale_down_sim_batch, which run
the lanes one after another on the device). This module owns the data
movement around that dispatch:

  * converters from the native codec's numpy export (NativeSnapshotState
    .export layout) or the tenants' resident device tensors to the tensor
    structs — shared by single worlds and lane-stacked worlds (the casts
    are elementwise, so a leading tenant axis rides through);
  * lane stacking with occupancy padding: a window of M tenants pads to the
    service's FIXED lane count B by repeating lane 0, so every window of a
    class has one shape (the stack cache keys and `batch_occupancy_ratio`
    read it); the batched sims compute a padded lane once, as lane 0;
  * a bounded stack cache: steady-state traffic (same members, unchanged
    world versions) reuses the stacked device tree instead of re-stacking
    every window;
  * InFlightBatch: the dispatched batch + its async result fetch
    (ops/hostfetch.fetch_pytree_async). `harvest()` blocks for the fetch,
    assembles every member's response (identical JSON to the serial path —
    the lane-exact contract of the batched sims extends through assembly),
    and resolves the tickets. The scheduler harvests one window late,
    overlapping fetch with the next window's dispatch.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from kubernetes_autoscaler_tpu_torch.models.cluster_state import (
    NodeGroupTensors,
    NodeTensors,
    PodGroupTensors,
    ScheduledPodTensors,
)
from kubernetes_autoscaler_tpu_torch.metrics import device
from kubernetes_autoscaler_tpu_torch.ops.hostfetch import to_host
from kubernetes_autoscaler_tpu_torch.sidecar import faults


class MemberFault(Exception):
    """One member's result is poisoned (NaN in its lane's outputs, or its
    per-member assembly raised): ONLY that member's ticket errors — the
    batch's other members are assembled and resolved normally, because
    the lanes are computationally independent (docs/ROBUSTNESS.md)."""

    def __init__(self, tenant: str, message: str):
        super().__init__(f"member {tenant or 'default'!r}: {message}")
        self.tenant = tenant


@dataclass
class UpLane:
    """Prepared scale-up input for one tenant: class-shaped world sections
    (the tenant's RESIDENT device arrays from server._export_dev — numpy
    also accepted for tests/tools) + the request's encoded node-group
    template fields."""

    nodes: dict
    groups: dict
    pods: dict
    ng: dict
    ids: list[str]


@dataclass
class DownLane:
    nodes: dict
    groups: dict
    pods: dict
    threshold: float
    # host copy of the nodes-section valid mask for response assembly —
    # device lanes must not force a d2h round trip per member just to
    # index the fetched results
    valid_np: np.ndarray | None = None


# ---- numpy export → tensor structs (single or lane-stacked) ----
#
# A field that is already a tensor keeps its device (the resident lanes of
# server._export_dev); a numpy field goes to `device` (None = CUDA, raising
# without it; tests and tools pass "cpu"). The bool casts are elementwise,
# so a leading tenant axis rides through.

def _t(x, device):
    import torch

    if isinstance(x, torch.Tensor):
        return x
    from kubernetes_autoscaler_tpu_torch.device import resolve_device

    return torch.from_numpy(np.ascontiguousarray(x)).to(
        resolve_device(device))


def _b(x, device):
    import torch

    return _t(x, device).to(torch.bool)


def node_tensors(a: dict, device=None) -> NodeTensors:
    return NodeTensors(
        cap=_t(a["cap"], device), alloc=_t(a["alloc"], device),
        label_hash=_t(a["label_hash"], device),
        taint_exact=_t(a["taint_exact"], device),
        taint_key=_t(a["taint_key"], device),
        used_ports=_t(a["used_ports"], device),
        zone_id=_t(a["zone_id"], device),
        group_id=_t(a["group_id"], device),
        ready=_b(a["ready"], device),
        schedulable=_b(a["schedulable"], device),
        valid=_b(a["valid"], device),
    )


def podgroup_tensors(a: dict, device=None) -> PodGroupTensors:
    return PodGroupTensors(
        req=_t(a["req"], device), count=_t(a["count"], device),
        sel_req=_t(a["sel_req"], device), sel_neg=_t(a["sel_neg"], device),
        tol_exact=_t(a["tol_exact"], device),
        tol_key=_t(a["tol_key"], device),
        tolerate_all=_b(a["tolerate_all"], device),
        port_hash=_t(a["port_hash"], device),
        anti_affinity_self=_b(a["anti_self"], device),
        valid=_b(a["valid"], device),
        needs_host_check=_b(a["lossy"], device),
    )


def sched_tensors(a: dict, device=None) -> ScheduledPodTensors:
    return ScheduledPodTensors(
        req=_t(a["req"], device), node_idx=_t(a["node_idx"], device),
        group_ref=_t(a["group_ref"], device),
        movable=_b(a["movable"], device),
        blocks=_b(a["blocks"], device),
        valid=_b(a["valid"], device),
    )


def nodegroup_tensors(a: dict, device=None) -> NodeGroupTensors:
    return NodeGroupTensors(
        cap=_t(a["cap"], device), label_hash=_t(a["label_hash"], device),
        taint_exact=_t(a["taint_exact"], device),
        taint_key=_t(a["taint_key"], device),
        zone_id=_t(a["zone_id"], device), max_new=_t(a["max_new"], device),
        price_per_node=_t(a["price_per_node"], device),
        valid=_b(a["valid"], device),
    )


def nodegroup_np(t: NodeGroupTensors) -> dict:
    """Host mirror of an encoded NodeGroupTensors (encode_node_groups
    uploads; batching stacks on the host first, so pull it back once and
    cache)."""
    return {
        "cap": to_host(t.cap), "label_hash": to_host(t.label_hash),
        "taint_exact": to_host(t.taint_exact),
        "taint_key": to_host(t.taint_key),
        "zone_id": to_host(t.zone_id), "max_new": to_host(t.max_new),
        "price_per_node": to_host(t.price_per_node),
        "valid": to_host(t.valid).astype(np.uint8),
    }


def stack_fields(dicts: list[dict]) -> dict:
    """Stack each field over a new leading lane axis. Device lanes (the
    resident per-tenant tensors) stack ON-DEVICE via torch.stack, on the
    lanes' device with no host round trip — zero h2d world bytes per
    window; numpy lanes keep the host np.stack (uploaded once by the
    tensor-struct casts), preserving the path for tests/tools that build
    lanes from numpy exports. torch.stack writes fresh storage, so a cached
    stack never aliases a tenant's resident lanes."""
    first = dicts[0]
    if any(not isinstance(v, np.ndarray) for v in first.values()):
        import torch

        return {k: torch.stack([d[k] for d in dicts]) for k in first}
    return {k: np.stack([d[k] for d in dicts]) for k in first}


def pad_lanes(items: list, lanes: int) -> list:
    """Occupancy padding: repeat lane 0 up to the fixed lane count. The
    padded lanes are a real (duplicate) world whose outputs are simply not
    delivered — masking by duplication keeps every lane's inputs
    well-formed (no all-zero worlds hitting div-by-zero style edges); the
    batched sims give them lane 0's outputs without computing them."""
    if len(items) > lanes:
        raise ValueError(f"{len(items)} lanes exceed the batch width {lanes}")
    return items + [items[0]] * (lanes - len(items))


class StackCache:
    """Bounded LRU of stacked device trees keyed by (batch key + member
    world fingerprints). Steady-state windows — same members, unchanged
    versions — skip the restack entirely, so a served window costs one
    batched dispatch plus one batched fetch."""

    def __init__(self, capacity: int = 32):
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key, build):
        hit = self._d.get(key)
        if hit is not None:
            self._d.move_to_end(key)
            self.hits += 1
            return hit
        self.misses += 1
        val = build()
        self._d[key] = val
        if device.LEDGER is not None:
            # HBM residency ledger: stacked pytrees are device arrays held
            # across windows; key by insertion identity so an evicted
            # entry's registration is dropped with it
            device.LEDGER.track("stack_cache", self._ledger_key(key), val)
        while len(self._d) > self.capacity:
            old_key, _old = self._d.popitem(last=False)
            if device.LEDGER is not None:
                device.LEDGER.release(owner="stack_cache",
                                      key=self._ledger_key(old_key))
        return val

    @staticmethod
    def _ledger_key(key) -> str:
        import hashlib

        return hashlib.sha1(repr(key).encode()).hexdigest()[:12]


class InFlightBatch:
    """One dispatched window batch: resolve tickets at harvest time.

    Failure contract (docs/ROBUSTNESS.md): NO ticket may be left pending —
    a client blocked on an unresolved ticket waits out its full gRPC
    deadline for nothing. A batch-level failure (fetch raised, assembly
    length mismatch) is delegated to `on_failure` (the service's bisection
    re-dispatcher) when wired, else fails every still-pending member with
    the error; a PER-member failure (MemberFault in the assembled results)
    errors only that member and reports it through `on_member_fault` (the
    quarantine hook) while co-members resolve normally."""

    def __init__(self, tickets, fetch, assemble, batch_info: dict,
                 on_done=None, on_failure=None, on_member_fault=None):
        self.tickets = tickets
        self.fetch = fetch
        self.assemble = assemble          # host pytree -> list of responses
        self.batch_info = batch_info
        self.on_done = on_done
        self.on_failure = on_failure
        self.on_member_fault = on_member_fault

    def harvest(self) -> None:
        try:
            if faults.PLAN is not None:
                faults.PLAN.fire(
                    "harvest", tenants=[t.tenant for t in self.tickets])
            host = self.fetch.get()
            harvested_ns = time.perf_counter_ns()
            results = self.assemble(host)
            if len(results) != len(self.tickets):
                # zip would silently truncate and leave the surplus tickets
                # blocked until their deadline — the exact hang this layer
                # exists to prevent (tests/test_fault_injection.py)
                raise RuntimeError(
                    f"assembly returned {len(results)} results for "
                    f"{len(self.tickets)} members")
            self.batch_info["dur_ns"] = (
                time.perf_counter_ns() - self.batch_info["t0_ns"])
            for t, r in zip(self.tickets, results):
                t.stamps.harvested = harvested_ns
                t.stamps.resolved = time.perf_counter_ns()
                if isinstance(r, Exception):
                    t.resolve(error=r, batch_info=self.batch_info)
                    if self.on_member_fault is not None:
                        try:
                            self.on_member_fault(t, r)
                        except Exception:  # noqa: BLE001 — best-effort hook
                            pass
                else:
                    t.resolve(result=r, batch_info=self.batch_info)
            if self.on_done is not None:
                self.on_done(self)
        except Exception as e:  # noqa: BLE001 — every ticket must resolve
            live = [t for t in self.tickets if not t.done.is_set()]
            if self.on_failure is not None and live:
                try:
                    self.on_failure(live, e)
                    return
                except Exception as e2:  # noqa: BLE001 — bisection failed
                    e = e2
            for t in live:
                if not t.done.is_set():
                    t.resolve(error=e)


def stack_up_lanes(lanes_list: list[UpLane], device=None):
    """Stacked device inputs for scale_up_sim_batch."""
    return (
        node_tensors(stack_fields([ln.nodes for ln in lanes_list]), device),
        podgroup_tensors(stack_fields([ln.groups for ln in lanes_list]),
                         device),
        sched_tensors(stack_fields([ln.pods for ln in lanes_list]), device),
        nodegroup_tensors(stack_fields([ln.ng for ln in lanes_list]), device),
    )


def stack_down_lanes(lanes_list: list[DownLane], device=None):
    """Stacked device inputs for scale_down_sim_batch (thresholds ride as
    an f32[B] tensor on the lanes' device — mixed per-tenant thresholds
    share one dispatch)."""
    import torch

    nt = node_tensors(stack_fields([ln.nodes for ln in lanes_list]), device)
    return (
        nt,
        podgroup_tensors(stack_fields([ln.groups for ln in lanes_list]),
                         device),
        sched_tensors(stack_fields([ln.pods for ln in lanes_list]), device),
        torch.tensor([ln.threshold for ln in lanes_list],
                     dtype=torch.float32, device=nt.cap.device),
    )


def assemble_up_one(host: dict, ln: UpLane, i: int) -> dict:
    """One member's scale-up response from the batched fetch —
    field-for-field the serial handler's JSON (ids mapping, option list,
    fits/remaining)."""
    best = int(host["best"][i])
    return {
        "best": ln.ids[best] if 0 <= best < len(ln.ids) else "",
        "options": [
            {
                "id": ln.ids[j],
                "node_count": int(host["node_count"][i, j]),
                "pods": int(host["pods"][i, j]),
                "waste": float(host["waste"][i, j]),
                "price": float(host["price"][i, j]),
                "valid": bool(host["valid"][i, j]),
            }
            for j in range(len(ln.ids))
        ],
        "fits_existing": int(host["fits"][i]),
        "remaining": int(host["remaining"][i]),
    }


def assemble_down_one(host: dict, ln: DownLane, i: int) -> dict:
    # device lanes carry a host copy of the valid mask (valid_np) so
    # assembly never round-trips to the device
    valid_src = ln.valid_np if ln.valid_np is not None else ln.nodes["valid"]
    valid = to_host(valid_src).astype(bool)
    return {
        "eligible": np.nonzero(host["eligible"][i] & valid)[0].tolist(),
        "drainable": np.nonzero(host["drainable"][i] & valid)[0].tolist(),
        "utilization": [round(float(u), 4)
                        for u in host["util"][i][valid]],
    }


def _result_poisoned(r, path="") -> str:
    """Name the first non-finite float in an assembled response ('' when
    clean): a poisoned lane (corrupted inputs, device fault) surfaces as
    NaN/inf in ITS outputs only — lanes are independent — so the check
    isolates the offender without failing the batch."""
    import math

    if isinstance(r, dict):
        for k, v in r.items():
            bad = _result_poisoned(v, f"{path}.{k}" if path else k)
            if bad:
                return bad
    elif isinstance(r, (list, tuple)):
        for j, v in enumerate(r):
            bad = _result_poisoned(v, f"{path}[{j}]")
            if bad:
                return bad
    elif isinstance(r, float) and not math.isfinite(r):
        return f"{path}={r}"
    return ""


def assemble_members(host: dict, members: list, tenants: list[str],
                     assemble_one) -> list:
    """Fault-isolated per-member assembly: each member assembles inside its
    own guard (assembly fault hook, NaN screen, exception fence), so one
    poisoned lane yields one MemberFault entry in the result list while its
    co-members' responses stay bit-identical to a fault-free run."""
    out: list = []
    for i, ln in enumerate(members):
        tenant = tenants[i] if i < len(tenants) else ""
        try:
            if faults.PLAN is not None:
                faults.PLAN.fire("assembly", tenant=tenant)
            r = assemble_one(host, ln, i)
            bad = _result_poisoned(r)
            if bad:
                raise MemberFault(
                    tenant, f"non-finite result plane ({bad}) — "
                            f"poisoned lane quarantined")
            out.append(r)
        except MemberFault as e:
            out.append(e)
        except Exception as e:  # noqa: BLE001 — isolate to this member
            out.append(MemberFault(tenant, f"assembly failed: {e!r}"))
    return out


def assemble_up(host: dict, members: list[UpLane]) -> list[dict]:
    """Whole-batch scale-up assembly (tests/tools; the server uses the
    fault-isolated assemble_members wrapper)."""
    return [assemble_up_one(host, ln, i) for i, ln in enumerate(members)]


def assemble_down(host: dict, members: list[DownLane]) -> list[dict]:
    return [assemble_down_one(host, ln, i) for i, ln in enumerate(members)]

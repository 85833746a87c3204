"""Branch points and variant lanes — where a multiverse comes from.

Counterpart of the reference package's `whatif/variants.py`. A `Branch` is
one frozen world: the exact tensors a live fused dispatch read
(`branch_from_live`, straight out of the autoscaler's fused context) or any
journal cursor replayed back to that point (`branch_from_journal`, through
the port's replay harness). `build_lanes` fans a Branch out into B
hypothesis lanes: lane 0 is ALWAYS the null hypothesis — the unperturbed
branch world, pinned bit-identical to the live fused loop — and lanes 1..
apply per-variant perturbations (price schedules, scale-up caps,
scale-down thresholds, injected node failures, workload scaling).

Perturbations are value edits on host copies of the branch planes; the
unperturbed leaves are copied byte for byte, never recomputed, so a knob
that a variant leaves at its default cannot drift the lane. Every lane has
storage of its own (no lane is a view of another's), and the live loop
replaces its input tensors out of place, so a branch stays as it was taken
while the loop runs on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from kubernetes_autoscaler_tpu_torch.ops.hostfetch import to_host
from kubernetes_autoscaler_tpu_torch.whatif.kernel import _map


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """One hypothesis lane. Defaults are the null hypothesis — a spec with
    every field at default IS lane 0's semantics."""

    name: str = ""
    price_scale: float = 1.0          # scales every group's price_per_node
    max_new_cap: int | None = None    # extra min() on the composed limit cap
    threshold: float = 0.5            # scale-down utilization threshold
    fail_nodes: tuple[int, ...] = ()  # node indices reclaimed at branch time
    pending_scale: float = 1.0        # scales pending-pod counts (ceil)

    def is_null(self) -> bool:
        return (self.price_scale == 1.0 and self.max_new_cap is None
                and self.threshold == 0.5 and not self.fail_nodes
                and self.pending_scale == 1.0)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "VariantSpec":
        return cls(
            name=str(d.get("name", "")),
            price_scale=float(d.get("price_scale", 1.0)),
            max_new_cap=(int(d["max_new_cap"])
                         if d.get("max_new_cap") is not None else None),
            threshold=float(d.get("threshold", 0.5)),
            fail_nodes=tuple(int(i) for i in d.get("fail_nodes", ())),
            pending_scale=float(d.get("pending_scale", 1.0)),
        )

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name, "price_scale": self.price_scale,
            "max_new_cap": self.max_new_cap, "threshold": self.threshold,
            "fail_nodes": list(self.fail_nodes),
            "pending_scale": self.pending_scale,
        }


@dataclasses.dataclass
class Branch:
    """One frozen branch world + the static arguments of its fused
    dispatch. Tensors are the SAME objects the source loop dispatched, on
    its device — branching copies nothing until lanes are built."""

    nodes: Any                  # NodeTensors
    specs: Any                  # PodGroupTensors
    scheduled: Any              # ScheduledPodTensors
    groups: Any                 # NodeGroupTensors
    limit_cap: np.ndarray       # i32[NG] host-composed cap
    statics: dict[str, Any]     # run_once_fused static args (incl. dims)
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)


def branch_from_live(autoscaler) -> Branch:
    """Branch from the live fused context — the exact input tensors of the
    most recent fused dispatch (pre-placement world + group tensors +
    composed cap). Requires a completed fused loop."""
    ctx = getattr(autoscaler, "_fused_ctx", None)
    if ctx is None:
        raise ValueError(
            "no fused context to branch from — run at least one loop with "
            "fused_loop=True (phased/deferred loops leave no branch point)")
    statics = dict(ctx["statics"])
    if statics.get("with_constraints"):
        raise ValueError(
            "constraint-overlay worlds are serial-only: the multiverse "
            "lanes run the unconstrained fused body")
    nodes, specs, scheduled, _planes = ctx["inputs"]
    prep = ctx["prep"]
    return Branch(
        nodes=nodes, specs=specs, scheduled=scheduled,
        groups=prep.group_tensors,
        limit_cap=np.asarray(prep.limit_cap, np.int32),
        statics=statics,
        meta={"source": "live"},
    )


def branch_from_journal(path: str, upto: int | None = None,
                        device=None) -> Branch:
    """Branch from a journal cursor: replay the journal (fused loop, the
    replay harness) on `device` (None = CUDA) up to loop `upto` and branch
    the reconstructed fused context. Deterministic — the same (journal,
    cursor) always yields the same branch planes, which is what makes
    what-if reports replayable."""
    from kubernetes_autoscaler_tpu_torch.replay.harness import replay_journal

    rep = replay_journal(path, upto=upto, keep_autoscaler=True,
                         options_override={"fused_loop": True},
                         device=device)
    a = rep.get("_autoscaler")
    if a is None or getattr(a, "_fused_ctx", None) is None:
        raise ValueError(
            f"journal {path} yielded no fused context to branch "
            f"(loops replayed: {rep.get('loops', 0)})")
    br = branch_from_live(a)
    br.meta = {"source": "journal", "path": str(path), "upto": upto,
               "loops": rep.get("loops")}
    return br


@dataclasses.dataclass
class Lanes:
    """The stacked multiverse inputs: every tensor gains leading axis B.
    `real` counts requested lanes; rows real.. are null-lane padding up to
    a lane-count rung and are masked out of reports."""

    nodes: Any
    specs: Any
    scheduled: Any
    groups: Any
    limit_cap: Any              # i32[B, NG]
    thresholds: Any             # f32[B]
    variants: list[VariantSpec]
    real: int
    statics: dict[str, Any]
    meta: dict[str, Any]


def _bcast(tree, b: int):
    """Every tensor leaf repeated B times along a new axis 0, each lane its
    own storage."""
    return _map(lambda x: x.unsqueeze(0).expand((b,) + tuple(x.shape))
                .contiguous(), tree)


def build_lanes(branch: Branch, variants: Sequence[VariantSpec],
                pad_to: int | None = None) -> Lanes:
    """Fan a Branch into B lanes on the branch's device. Prepends the null
    lane if the caller's variants[0] is not already null; pads with null
    lanes to `pad_to` (a lane-count rung) so lane-count churn never changes
    the lanes' shapes. Unperturbed knobs keep the branch leaves' bytes."""
    vs = list(variants)
    if not vs or not vs[0].is_null():
        vs = [VariantSpec(name="null")] + vs
    real = len(vs)
    if pad_to is not None and pad_to > len(vs):
        vs = vs + [VariantSpec(name="pad")] * (pad_to - len(vs))
    b = len(vs)
    dev = branch.nodes.cap.device

    nodes = _bcast(branch.nodes, b)
    specs = _bcast(branch.specs, b)
    scheduled = _bcast(branch.scheduled, b)
    groups = _bcast(branch.groups, b)

    # per-lane knobs, edited on host copies only where a variant moves them
    cap = np.broadcast_to(branch.limit_cap[None],
                          (b,) + branch.limit_cap.shape).copy()
    price0 = to_host(branch.groups.price_per_node)
    prices = np.array(np.broadcast_to(price0[None], (b,) + price0.shape),
                      np.float32)
    n = branch.nodes.n
    fail = np.zeros((b, n), bool)
    count0 = to_host(branch.specs.count)
    counts = np.array(np.broadcast_to(count0[None], (b,) + count0.shape),
                      np.int32)
    thresholds = np.zeros((b,), np.float32)
    touched_price = touched_count = False
    for i, v in enumerate(vs):
        thresholds[i] = v.threshold
        if v.max_new_cap is not None:
            cap[i] = np.minimum(cap[i], np.int32(v.max_new_cap))
        if v.price_scale != 1.0:
            prices[i] = prices[i] * np.float32(v.price_scale)
            touched_price = True
        if v.pending_scale != 1.0:
            counts[i] = np.ceil(
                counts[i] * np.float64(v.pending_scale)).astype(np.int32)
            touched_count = True
        for idx in v.fail_nodes:
            if 0 <= idx < n:
                fail[i, idx] = True

    def up(x):
        return torch.from_numpy(x).to(dev)

    if touched_price:
        groups = groups.replace(price_per_node=up(prices))
    if touched_count:
        specs = specs.replace(count=up(counts))
    if fail.any():
        fm = up(fail)
        nodes = nodes.replace(ready=nodes.ready & ~fm,
                              schedulable=nodes.schedulable & ~fm)

    return Lanes(
        nodes=nodes, specs=specs, scheduled=scheduled, groups=groups,
        limit_cap=up(cap), thresholds=up(thresholds),
        variants=vs, real=real, statics=dict(branch.statics),
        meta=dict(branch.meta),
    )

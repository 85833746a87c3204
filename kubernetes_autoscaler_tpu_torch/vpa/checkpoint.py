"""VPA checkpointing: persist/restore histogram state.

Reference counterpart: recommender/checkpoint/checkpoint_writer.go +
VerticalPodAutoscalerCheckpoint CRD — serialized bucket weights per
(VPA, container), maintained periodically (routines/recommender.go:154
MaintainCheckpoints) so a recommender restart keeps its history.

Serialization: one npz per recommender (bucket weights + totals + key index) —
the CRD-per-aggregate layout of the reference collapses into two dense arrays.
The keys and layout are the reference package's vpa/checkpoint.py's, so a
checkpoint written by either package loads in the other with its arrays
byte-equal. Saving reads the banks through `to_host`; loading uploads them
to the recommender's device, with any subnormal entry flushed to zero (the
bank's invariant, vpa/histogram.py: XLA's CPU reads a subnormal as zero;
neither package writes one).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from kubernetes_autoscaler_tpu_torch.ops.hostfetch import to_host
from kubernetes_autoscaler_tpu_torch.vpa.histogram import flush_subnormals
from kubernetes_autoscaler_tpu_torch.vpa.recommender import Recommender


def save_checkpoint(rec: Recommender, path: str, now: float) -> None:
    keys = [list(k) for k, _ in sorted(rec._index.items(), key=lambda kv: kv[1])]
    np.savez_compressed(
        path,
        cpu_weights=to_host(rec.cpu.weights),
        cpu_total=to_host(rec.cpu.total),
        mem_weights=to_host(rec.memory.weights),
        mem_total=to_host(rec.memory.total),
        ref_time=np.asarray([now]),
        keys=json.dumps(keys),
    )


def load_checkpoint(path: str, device=None) -> Recommender | None:
    """The recommender saved at `path`, its banks on `device` (None = CUDA,
    raising without a card); None when there is no checkpoint."""
    if not os.path.exists(path):
        return None
    data = np.load(path, allow_pickle=False)
    keys = json.loads(str(data["keys"]))
    rec = Recommender(initial_aggregates=int(data["cpu_weights"].shape[0]),
                      device=device)
    rec._index = {tuple(k): i for i, k in enumerate(keys)}
    dev = rec.cpu.device

    def upload(key: str) -> torch.Tensor:
        return flush_subnormals(torch.tensor(data[key], device=dev))

    rec.cpu.weights = upload("cpu_weights")
    rec.cpu.total = upload("cpu_total")
    rec.memory.weights = upload("mem_weights")
    rec.memory.total = upload("mem_total")
    rec.cpu.ref_time = rec.memory.ref_time = float(data["ref_time"][0])
    return rec

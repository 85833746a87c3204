"""Deterministic flight journal: record/replay provenance for every
simulated decision.

`journal.py` writes the append-only record stream (full world snapshot on
the first loop, compact deltas after — pods added/deleted, node/taint/
occupancy changes — plus config/backend identity and digests of every
verdict surface); `harness.py` reconstructs worlds from snapshot+deltas,
re-executes the recorded loops bit-for-bit and emits a drift report;
`python -m kubernetes_autoscaler_tpu_torch.replay <journal>` is the CLI.

docs/REPLAY.md documents the record format and the cross-backend
divergence oracle.
"""

from kubernetes_autoscaler_tpu_torch.replay.journal import (  # noqa: F401
    JournalWriter,
    TenantJournal,
    backend_identity,
    canonical,
    collect_outputs,
    digest_of,
    groups_state,
    surface_digests,
)

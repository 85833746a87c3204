"""Deterministic flight journal: record/replay provenance for every
simulated decision.

`journal.py` is the port's copy of the reference package's record stream
code. The control loop uses its outputs surface (`collect_outputs`,
`surface_digests`, `groups_state`, `backend_identity`); the writer is
copied but the loop refuses `journal_dir`, and the replay harness and its
CLI are not ported (ROADMAP A2).
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

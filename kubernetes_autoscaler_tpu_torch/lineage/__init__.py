"""Decision lineage: the object-centric provenance join over every
cursor-stamped evidence store (docs/LINEAGE.md).

The stack emits five stores that all stamp the journal cursor — journal
records (replay/), Perfetto flight dumps (metrics/trace.py), audit
bundles (audit/shadow.py), restart records (core/supervisor.py) and
perfwatch triage bundles (perfwatch/triage.py) — plus the event ring
(events.py). This package joins them per (object kind, name) × loop:

  index.py   LineageIndex — incremental, bounded-memory index over a
             journal dir, stitching every artifact it can resolve back
             to a record digest; LineageRing — the live in-process
             variant StaticAutoscaler feeds (served on /whyz,
             /snapshotz and the sidecar Explain RPC).
  query.py   why / timeline / diff renderers (human text + JSON).
  __main__   `python -m kubernetes_autoscaler_tpu_torch.lineage` CLI, with
             --follow tailing a live journal dir.

Everything here is a pure observer: host-side dict work, zero device
dispatches, overhead metered like the journal's.
"""

from kubernetes_autoscaler_tpu_torch.lineage.index import (  # noqa: F401
    LineageIndex,
    LineageRing,
    entries_from_outputs,
)

"""Counterfactual multiverse — what-if batches over hypothesis lanes and
device-resident time-compressed rollouts (docs/WHATIF.md).

Counterpart of the reference package's `whatif/`. A leading lane axis B
of perturbed worlds + per-lane policy scalars runs through the port's own
`ops/autoscale_step.run_once_fused` body, lane by lane, plus a rollout
that advances the resident planes through T simulated loops on the device
and fetches only the decision trajectory. Lane b=0 is always the null
hypothesis — the unperturbed branch world — and stays bit-identical to the
live fused loop by construction (tests/test_torch_whatif.py pins this).
"""

from kubernetes_autoscaler_tpu_torch.whatif.kernel import (  # noqa: F401
    LaneSummary,
    RolloutStep,
    multiverse_step,
    rollout_fused,
    rollout_multiverse,
)
from kubernetes_autoscaler_tpu_torch.whatif.variants import (  # noqa: F401
    Branch,
    Lanes,
    VariantSpec,
    branch_from_journal,
    branch_from_live,
    build_lanes,
)
from kubernetes_autoscaler_tpu_torch.whatif.generator import (  # noqa: F401
    WorkloadSpec,
    generate_workload,
)
from kubernetes_autoscaler_tpu_torch.whatif.report import (  # noqa: F401
    build_report,
    lane_digests,
)

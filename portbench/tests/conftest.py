"""Shared pieces of the benchmark's own tests (run with
`python -m pytest portbench/tests -q`; the `cuda` ones on a card).

SMALL shrinks a configuration to a world the CPU decides in well under a
second; SMALL_TRAFFIC shrinks the churn, the burst and the residents that
leave to match. The shapes (labels, taints, constraints, groups) stay.
"""

import pytest
import torch

SMALL = dict(nodes=60, pending_pods=500, residents_per_node=2, node_bucket=64,
             max_new_nodes=32, template_max_new=40)
SMALL_TRAFFIC = {
    "steady": dict(churn=50, burst={"variant": 2, "pods": 5,
                                    "cpu_milli": 14000, "mem_mib": 4096}),
    "consolidate": dict(residents_leave_per_variant=10),
}
CELLS = ("ca-5k.steady", "ca-5k-affinity.consolidate")
SEED = 2 ** 33 + 12345          # more than 32 bits, as the driver's are


def small_run(cell, seed=SEED, **kw):
    from portbench import run

    traffic = cell.split(".")[1]
    return run.run_cell(cell, seed, 1.0, kw.pop("trace", False), device="cpu",
                        cfg_overrides=SMALL,
                        traffic_overrides=SMALL_TRAFFIC[traffic], **kw)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"

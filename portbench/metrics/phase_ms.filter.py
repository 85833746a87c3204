"""phase_ms.filter: the device time of run_once_fused's `filter` phase, from
CUDA events recorded at its on_phase boundaries, mean ms a decision over
the window of a `--trace 1` run."""


def read(ctx):
    return ctx.mean_phase_ms("filter")

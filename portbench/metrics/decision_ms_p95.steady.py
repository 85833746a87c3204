"""decision_ms_p95.steady: the 95th percentile of every window decision's
latency (host clock, ms), as decision_ms_p95 measures it, read in a
`--trace 1` run, whose window also records the phases' CUDA events. In the
cells that list it, a process's host speed moves it more than a change
could, so it is held per layer there, not end to end."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.lat_ms, 95)) if ctx.lat_ms else None

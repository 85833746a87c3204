"""enqueue_ms: the host's time to queue one decision, by the host clock
from the call into run_once_fused to its return, with no synchronize; mean
ms a decision over the window of a `--trace 1` run."""


def read(ctx):
    return ctx.mean(ctx.enqueue_ms)

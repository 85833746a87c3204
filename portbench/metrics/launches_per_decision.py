"""launches_per_decision: device kernels (memory copies and sets left out)
that torch.profiler saw, per traced decision."""


def read(ctx):
    t = ctx.traced
    return t.launches() / t.decisions if t and t.decisions else None

"""device_idle: the share (%) of the traced window in which no operation
ran on the device (the union of the profiler's device intervals)."""


def read(ctx):
    t = ctx.traced
    if not t or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

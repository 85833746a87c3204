"""decisions_per_s.steady: all decisions of the window over its seconds, as
decisions_per_s measures it, read in a `--trace 1` run, whose window also
records the phases' CUDA events. In the cells that list it, a process's host
speed moves it more than a change could, so it is held per layer there, not
end to end."""


def read(ctx):
    return ctx.n_done / ctx.window_s if ctx.window_s > 0 else None

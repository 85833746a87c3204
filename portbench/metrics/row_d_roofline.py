"""row_d_roofline: row D, csrc/drain.cu: the fit plane's pre-pass and the
drain sweep.

The least time that the traced decisions' calls of it could take on their
inputs (portbench/bounds.py, with the work counted by the reference's pass
over the same inputs), over the kernels' summed device time in the
profiler, in %. Nothing where the traced decisions launched none of it.
"""

KERNELS = ("fit_plane_kernel", "drain_kernel")


def read(ctx):
    return ctx.roofline("row_d", KERNELS)

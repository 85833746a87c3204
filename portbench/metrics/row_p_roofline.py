"""row_p_roofline: row P, csrc/predicates.cu: the resident pre-pass and the predicate plane.

The least time that the traced decisions' calls of it could take on their
inputs (portbench/bounds.py, with the work counted by the reference's pass
over the same inputs), over the kernels' summed device time in the
profiler, in %. Nothing where the traced decisions launched none of it.
"""

KERNELS = ("resident_kernel", "plane_kernel")


def read(ctx):
    return ctx.roofline("row_p", KERNELS)

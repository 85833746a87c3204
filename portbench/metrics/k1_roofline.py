"""k1_roofline: K1, csrc/pack.cu: the batched FFD pack.

The least time that the traced decisions' calls of it could take on their
inputs (portbench/bounds.py, with the work counted by the reference's pass
over the same inputs), over the kernels' summed device time in the
profiler, in %. Nothing where the traced decisions launched none of it.
"""

KERNELS = ("pack_batched_kernel",)


def read(ctx):
    return ctx.roofline("k1", KERNELS)

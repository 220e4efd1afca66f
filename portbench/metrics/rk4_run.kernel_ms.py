"""Mean device time of one launch of the RK4 whole-run kernel
(``csrc/rk4_run*.cu`` ``rk4_kernel``), ms, in the traced window."""


def read(ctx):
    return ctx.kernel_ms("rk4_kernel")

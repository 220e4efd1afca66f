"""Mean device time of one launch of the dense whole-run kernel
(``csrc/dense_run*.cu`` ``dense_kernel``), ms, in the traced window."""


def read(ctx):
    return ctx.kernel_ms("dense_kernel")

"""The RK4 whole-run kernel's share of its roofline, %: the least time of
the request's work on the card (``work.rk4_bound``: the steps of the lanes
alive after them, the bytes in and out once, over the H100's published
peaks) over the kernel's mean device time."""


def read(ctx):
    ms = ctx.kernel_ms("rk4_kernel")
    bound = ctx.bounds.get("rk4_run")
    if ms is None or bound is None:
        return None
    return 100.0 * bound.ms / ms

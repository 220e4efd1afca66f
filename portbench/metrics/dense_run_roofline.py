"""The dense whole-run kernel's share of its roofline, %: the least time
of the request's work on the card (``work.dense_run_bound``: the step
attempts the run counts, the rows it keeps, the bytes in and out once,
over the H100's published peaks) over the kernel's mean device time."""


def read(ctx):
    ms = ctx.kernel_ms("dense_kernel")
    bound = ctx.bounds.get("dense_run")
    if ms is None or bound is None:
        return None
    return 100.0 * bound.ms / ms

"""The device's idle share of the traced window, %: 1 - the union of the
intervals in which an operation ran on the card over the window."""


def read(ctx):
    if ctx.trace.window_us <= 0 or ctx.trace.busy_us <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us / ctx.trace.window_us)

"""A request's time outside its whole-run kernel, ms: the mean request wall
in the traced window (host clock, call to a synchronize) less the whole-run
kernel's mean device time per request. The driver and set-up around the
launch: ``trace_rays`` / ``_run_lanes``, ``initialize``, the compaction,
the entry stage, the expansion back to the full layout."""


def read(ctx):
    name = ctx.run_kernel()
    if name is None or not ctx.requests or ctx.request_ms is None:
        return None
    per_launch = ctx.kernel_ms(name)
    if per_launch is None:
        return None
    launches = ctx.launches.get(name, 0) / ctx.requests
    return ctx.request_ms - per_launch * launches

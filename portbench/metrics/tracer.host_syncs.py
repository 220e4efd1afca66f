"""Host syncs a request: the points where ``trace_rays`` (or
``trace_rays_ensemble``) waits for the card, the program's
``tracer.HOST_SYNCS`` (each upload of host data to the card, each read of
a value on it), over the whole-run launches of the process, times the
whole-run launches a traced request made. The program counts from its
import, so this is the mean over every request of the run (warm-up,
untraced and traced), which are all alike in a cell. None where the
program has no such counter, or ran no whole-run kernel (its plain paths
on the CPU)."""


def read(ctx):
    from rwrt_tpu_torch import tracer

    syncs = getattr(tracer, "HOST_SYNCS", None)
    launches = tracer.LAUNCHES + tracer.RK4_LAUNCHES + tracer.EXACT_LAUNCHES
    kernel = ctx.run_kernel()
    if syncs is None or not launches or kernel is None or not ctx.requests:
        return None
    return syncs / launches * ctx.launches[kernel] / ctx.requests

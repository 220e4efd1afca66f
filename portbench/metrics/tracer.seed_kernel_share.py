"""The share of the program's seed stages that ran as its seed kernel: the
program's ``tracer.SEED_LAUNCHES`` (one launch of ``csrc/seed.cu`` each)
over ``tracer.SEED_CALLS`` (every ``initialize``, plain or kernel). The
program counts from its import, so this is the share over every request
of the run (warm-up, untraced and traced), which are all alike in a cell.
None where the program has no such counters, or seeded nothing."""


def read(ctx):
    from rwrt_tpu_torch import tracer

    launches = getattr(tracer, "SEED_LAUNCHES", None)
    calls = getattr(tracer, "SEED_CALLS", None)
    if launches is None or not calls:
        return None
    return launches / calls

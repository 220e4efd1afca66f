"""Peak device memory over the window, GiB (``max_memory_allocated``):
the footprint of a request, which bounds the rays one run holds before a
user has to chunk it."""


def read(ctx):
    if not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 2 ** 30

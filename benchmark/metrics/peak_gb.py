"""The allocator's peak over the traced window (``max_memory_allocated``
after ``reset_peak_memory_stats``), in GB."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes > 0 else None

"""Device operations a step or clip: the sum of the per-op counts of the
trace's kernel, memcpy and memset rows (every device row that is not a
span's), over the traced steps or clips."""


def read(ctx):
    n = sum(count for _, count, _ in ctx.summary["kernels"])
    return n / ctx.steps if n else None

"""Device ms a clip of the copies between host and card (the batch in, the
videos back), from the trace's memcpy rows."""


def read(ctx):
    s = ctx.kernel_device_s(lambda n: n.startswith(("Memcpy HtoD", "Memcpy DtoH")))
    return 1e3 * s / ctx.steps if s > 0 else None

"""MAT's second stage, device ms a clip: the union of the device ranges of
the ``mat/decoder`` spans (the conv encoder, the style blend, the modulated
decoder and its toRGB layers, inside each ``mat/generator``), over the
traced clips."""


def read(ctx):
    s = ctx.span_device_s("mat/decoder")
    return 1e3 * s / ctx.steps if s > 0 else None

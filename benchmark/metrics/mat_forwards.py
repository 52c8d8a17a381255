"""MAT generator forwards a clip: the device rows of the ``mat/generator``
spans (one a forward, as ``MatInpainter.calls`` counts them), over the
traced clips."""


def read(ctx):
    n = sum(1 for name, _, _ in ctx.summary["span_ranges"] if name == "mat/generator")
    return n / ctx.steps if n else None

"""MAT's first stage, device ms a clip: the union of the device ranges of
the ``mat/transformer`` spans (the partial convolutions, the mask-aware Swin
stages, the style tokens and the first stage's decoder, inside each
``mat/generator``), over the traced clips."""


def read(ctx):
    s = ctx.span_device_s("mat/transformer")
    return 1e3 * s / ctx.steps if s > 0 else None

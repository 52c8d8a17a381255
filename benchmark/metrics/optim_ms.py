"""The training step's optimizer, device ms a step: the union of the device
ranges of the ``train/optimizer`` spans (``NetState.apply``: the gradients'
flat copy, the optional clip, Adam's loop over the leaves), over the traced
steps."""


def read(ctx):
    s = ctx.span_device_s("train/optimizer")
    return 1e3 * s / ctx.steps if s > 0 else None

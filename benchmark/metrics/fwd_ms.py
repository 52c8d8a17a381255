"""The training step's forward, device ms a step: the union of the device
ranges of the ``train/forward`` spans (``Trainer.step``'s loss, with the
nets', the warper's and the losses' spans inside it), over the traced
steps."""


def read(ctx):
    s = ctx.span_device_s("train/forward")
    return 1e3 * s / ctx.steps if s > 0 else None

"""WIF's device ms a clip: the union of the device ranges of the ``wif/*``
spans (``fuse_rec``, ``fuse_pred``), over the traced clips."""


def read(ctx):
    s = ctx.span_device_s("wif/")
    return 1e3 * s / ctx.steps if s > 0 else None

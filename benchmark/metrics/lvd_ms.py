"""LVD's device ms a step: the union of the device ranges of the ``lvd/*``
spans (encode_input, estimate_layer, estimate_pose, decode_alpha; the
forward only, as the spans stand), over the traced steps."""


def read(ctx):
    s = ctx.span_device_s("lvd/")
    return 1e3 * s / ctx.steps if s > 0 else None

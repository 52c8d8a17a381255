"""The losses' device ms a step: the union of the device ranges of the
``loss/*`` spans (regularizers, moving_objects, cell_dis, reconstruction:
the forward of the losses past the nets, inside ``train/forward``), over
the traced steps."""


def read(ctx):
    s = ctx.span_device_s("loss/")
    return 1e3 * s / ctx.steps if s > 0 else None

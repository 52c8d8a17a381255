"""The warper's device ms a clip or step: the union of the device ranges of
the ``warper/*`` spans (grids, grid_to_flow with K1, input_to_output with
K2; the forward only, as the spans stand), over the traced clips or steps."""


def read(ctx):
    s = ctx.span_device_s("warper/")
    return 1e3 * s / ctx.steps if s > 0 else None

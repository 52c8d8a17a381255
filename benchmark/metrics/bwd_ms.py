"""The training step's backward, device ms a step.

The autograd engine runs a CUDA backward on a thread of its own, so the
``train/backward`` span, opened on the step's thread, sees few of its
kernels. The backward is the only work between a step's forward and its
optimizer, so the reading is the time from the end of each traced step's
``train/forward`` device range to the start of its ``train/optimizer`` one,
summed over the steps. Where the ``train/backward`` ranges cover at least
95 % of those intervals, their union is read instead.

The H100 takes the interval: there the span's device range holds one
kernel of about 1 us (the loss's seed gradient, launched on the step's
thread) against about 266 ms from forward to optimizer (kitti.train_lvd).
"""

FORWARD, BACKWARD, OPTIMIZER = "train/forward", "train/backward", "train/optimizer"


def _rows(ctx, name):
    return sorted((s, e) for n, s, e in ctx.summary["span_ranges"] if n == name)


def _between_us(ctx) -> float:
    """The summed device us from each forward range's end to the start of
    the first optimizer range after it."""
    opt = [s for s, _ in _rows(ctx, OPTIMIZER)]
    total = 0.0
    for _, f1 in _rows(ctx, FORWARD):
        after = [s for s in opt if s >= f1]
        if after:
            total += after[0] - f1
    return total


def read(ctx):
    between = _between_us(ctx)
    if between <= 0:
        return None
    own = 1e6 * ctx.span_device_s(BACKWARD)
    us = own if own >= 0.95 * between else between
    return us / 1e3 / ctx.steps

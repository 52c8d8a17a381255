"""The traced steps' model FLOPs over the seconds in which an operation ran
on the card (the trace's busy time), over the card's float32 peak, in %:
the whole step's achieved rate while the card is busy, read beside its
kernels' rooflines."""
from wbench.bounds import FP32_FLOPS


def read(ctx):
    if not ctx.flops_per_step or not ctx.busy_s:
        return None
    return 100.0 * ctx.flops_per_step * ctx.steps / ctx.busy_s / FP32_FLOPS

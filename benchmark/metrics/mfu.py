"""The whole clip's or step's model FLOPs at the window's rate, over the
card's float32 peak, in %: the reference's count of a step
(``wbench/flops.py``: convolutions, matrix products, attention; forward for
evaluation, forward and backward for training) times the steps, over the
window's seconds on the host clock."""
from wbench.bounds import FP32_FLOPS


def read(ctx):
    if not ctx.flops_per_step:
        return None
    return 100.0 * ctx.flops_per_step * ctx.steps / ctx.window_s / FP32_FLOPS

"""The port's hand kernels against their roofline: the sum of their bounds
over the sum of their device time in the traced window, in %. The bounds
(wbench/bounds.py) come from the reference's own intermediates on the
cell's inputs; the reading is left out where the program's launch counts
differ from the launches those bounds stand for."""
from wbench.bounds import is_hand_kernel


def read(ctx):
    want = {k: v * ctx.steps for k, v in ctx.bound_launches_per_step.items()}
    got = {k: v for k, v in ctx.program_launches.items() if v}
    if not got or got != {k: round(v) for k, v in want.items() if v}:
        return None
    s = ctx.kernel_device_s(is_hand_kernel)
    if s <= 0:
        return None
    return 100.0 * ctx.bound_ms_per_step * ctx.steps / 1e3 / s

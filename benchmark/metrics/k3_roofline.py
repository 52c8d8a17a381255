"""K3 (the fused bias + activation, ``csrc/bias_act.cu``) against its
roofline: the sum of its launches' bounds over the device time of its rows
(``bias_act_*_kernel``) in the traced window, in %. The bounds
(``wbench/bounds_mat.py``: bytes once at 3.35 TB/s or float32 operations at
67 TFLOP/s, the larger) come from the plain reference's own activations on
the traced clips; the reading is left out where the program's K3 launches
differ from the launches those bounds stand for."""
from wbench.bounds_mat import NAME, is_k3


def read(ctx):
    if {k for k, v in ctx.bound_launches_per_step.items() if v} != {NAME}:
        return None  # bounds of other kernels too: not this cell's observer
    want = ctx.bound_launches_per_step.get(NAME, 0) * ctx.steps
    got = ctx.program_launches.get(NAME, 0)
    if not got or got != round(want):
        return None
    s = ctx.kernel_device_s(is_k3)
    if s <= 0:
        return None
    return 100.0 * ctx.bound_ms_per_step * ctx.steps / 1e3 / s

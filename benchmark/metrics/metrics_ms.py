"""The evaluator's scores, device ms a clip: the union of the device ranges
of the ``eval/metrics`` spans (L1, PSNR and SSIM of each video, each read
back to the host on its own), so the scores' kernels and the gaps of their
host reads between them, over the traced clips."""


def read(ctx):
    s = ctx.span_device_s("eval/metrics")
    return 1e3 * s / ctx.steps if s > 0 else None

"""MAT's device ms a clip: the union of the device ranges of the
``mat/generator`` spans (``MatInpainter``: one a generator forward, three a
512x1024 frame) and of the ``mat/transformer`` and ``mat/decoder`` spans
inside them, over the traced clips. The trace gives a kernel to the
innermost span open at its launch, so a ``mat/generator`` row alone runs
from the mapping's first kernel to its last."""

SPANS = ("mat/generator", "mat/transformer", "mat/decoder")


def read(ctx):
    ivals = sorted((s, e) for name, s, e in ctx.summary["span_ranges"] if name in SPANS)
    total, end = 0.0, -float("inf")
    for s0, s1 in ivals:
        if s1 > end:
            total += s1 - max(s0, end)
            end = s1
    return total / 1e3 / ctx.steps if total > 0 else None

"""The evaluator's copies as a phase, device ms a clip: the union of the
device ranges of the ``eval/copy_in`` and ``eval/copy_out`` spans, each
counted once where they nest or overlap, over the traced clips. A range runs
from the phase's first copy to its last, so it holds the copies and the
host's gaps between them; ``copy_ms`` is the memcpy time alone."""


def read(ctx):
    s = ctx.span_device_s("eval/copy_")
    return 1e3 * s / ctx.steps if s > 0 else None

"""Clips of every training step in the window (B a step), over the window
(the card drained at its end), in clips/s."""


def read(ctx):
    clips = ctx.work.get("clips")
    return clips / ctx.window_s if clips else None

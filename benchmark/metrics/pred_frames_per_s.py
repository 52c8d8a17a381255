"""Predicted frames (clip length less the context) of every clip that
completed in the window, over the window, in frames/s."""


def read(ctx):
    frames = ctx.work.get("frames")
    return frames / ctx.window_s if frames else None

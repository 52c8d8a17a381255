"""The share of the traced window in which no operation ran on the card:
1 - (union of the device's intervals) / (the synced host window), in %."""


def read(ctx):
    if ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)

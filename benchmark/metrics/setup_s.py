"""Process start to the first timed clip or step (imports, the CUDA context,
the inputs and weights made on the card, the program built and loaded,
the warm-up), in s."""


def read(ctx):
    return ctx.setup_s

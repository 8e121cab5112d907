"""From the process's start to the first timed call: imports, the card,
the kernels' build or load, the server, the data from the seed, the
warm-up."""


def read(ctx):
    return ctx.setup_s

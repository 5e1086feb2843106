"""Process start to the window's start (host clock): the kernels' load (and
on a first run their build), the graph's draw, the database build, the
prepares and the warm-up."""


def read(ctx):
    return ctx.setup_s

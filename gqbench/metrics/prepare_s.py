"""Host clock around the cell's ``GQFastEngine.prepare`` calls (parse,
plan, lower, fuse, compile), ending in a synchronise."""


def read(ctx):
    return ctx.phases.get("prepare_s")

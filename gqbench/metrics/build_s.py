"""Host clock around ``GQFastDatabase(schema, device=...)``, ending in a
synchronise: the host index build, the storage policy and the copy to the
device."""


def read(ctx):
    return ctx.phases.get("build_s")

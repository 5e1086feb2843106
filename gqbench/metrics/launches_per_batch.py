"""Kernels the profiler saw on the device in the traced window, over the
window's batches."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.batches:
        return None
    return sum(1 for e in tr.device if e[2] == "kernel") / len(tr.batches)

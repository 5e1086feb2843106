"""Device-to-host copy time in the traced window (the profiler's memcpy
events), in ms, over the window's batches."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.batches:
        return None
    ms = sum(e[1] for e in tr.device if e[2] == "gpu_memcpy" and "DtoH" in e[3]) / 1e3
    return ms / len(tr.batches)

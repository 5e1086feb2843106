"""Device bytes the built database holds (``torch.cuda.memory_allocated()``
after the build less before it, the benchmark's own tensors freed) over the
user data's bytes (every relation and attribute column at 4 B a value)."""


def read(ctx):
    return ctx.store_bytes / ctx.user_bytes if ctx.store_bytes > 0 else None

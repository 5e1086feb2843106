"""Answered requests over the window's seconds (host clock): from the first
request's issue to the last answer."""


def read(ctx):
    return ctx.answered / ctx.window_s if ctx.window_s > 0 else None

"""Calls completed in the window, over the window's wall time (its drain
and final synchronise included)."""


def read(ctx):
    if ctx.window_s <= 0:
        return None
    return ctx.completed / ctx.window_s

"""Decoded bytes (10^9) that the read calls returned in the window, all
clients together, over the window's length.  A failed call adds none."""


def read(ctx):
    if ctx.direction != "read" or ctx.trace is not None:
        return None
    return sum(c.decoded for c in ctx.calls if c.ok) / ctx.seconds / 1e9

"""Input bytes (10^9) of the write calls that returned in the window, all
clients together, over the window's length.  A failed call adds none."""


def read(ctx):
    if ctx.direction != "write" or ctx.trace is not None:
        return None
    return sum(c.decoded for c in ctx.calls if c.ok) / ctx.seconds / 1e9

"""The share of the traced window, in %, in which the card runs no record
of any client (the union of all kernels, copies and memsets on one
clock)."""


def read(ctx):
    if ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])

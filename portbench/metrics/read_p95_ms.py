"""The 95th percentile (nearest rank) of a read call's time from its
start to its return, over every call of every client in the window.  A
failed call counts as over any limit; where the percentile falls on one,
there is no number."""

import math


def read(ctx):
    if ctx.direction != "read" or ctx.trace is not None or not ctx.calls:
        return None
    ms = sorted((c.end - c.start) * 1e3 if c.ok else math.inf
                for c in ctx.calls)
    p95 = ms[math.ceil(0.95 * len(ms)) - 1]
    return p95 if math.isfinite(p95) else None

"""Per traced call, the milliseconds of the program's ``compute`` spans,
their children left out: the host issuing device work (the port's
kernels and plain torch ops)."""

from portbench import spans


def read(ctx):
    s = spans.per_call(ctx)
    if s is None:
        return None
    return 1e3 * s["self_s"].get("compute", 0.0) / s["calls"]

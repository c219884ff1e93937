"""Per traced call, the milliseconds of device copies between host and
card (the trace's ``Memcpy HtoD`` and ``Memcpy DtoH`` records)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["calls"]:
        return None
    calls = ctx.trace["calls"]
    return 1e3 * sum(c["copy_s"] for c in calls) / len(calls)

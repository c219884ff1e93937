"""Per traced call, the milliseconds of the benchmark's span around the API
call in which its client has no device record (kernel, copy or memset)
running: the host's own steps in the API and the codecs."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["calls"]:
        return None
    calls = ctx.trace["calls"]
    return 1e3 * sum(c["host_s"] for c in calls) / len(calls)

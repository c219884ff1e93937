"""Per traced call, the milliseconds of the program's ``stage`` spans,
their children left out: the host's own steps over bytes (Python and
NumPy) in the API and the codecs."""

from portbench import spans


def read(ctx):
    s = spans.per_call(ctx)
    if s is None:
        return None
    return 1e3 * s["self_s"].get("stage", 0.0) / s["calls"]

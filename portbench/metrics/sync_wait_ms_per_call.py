"""Per traced call, the milliseconds of the program's ``sync`` spans: the
host blocked on the card, copies back to the host included."""

from portbench import spans


def read(ctx):
    s = spans.per_call(ctx)
    if s is None:
        return None
    return 1e3 * s["total_s"].get("sync", 0.0) / s["calls"]

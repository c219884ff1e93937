"""Per traced call, the program's ``sync`` spans: the times the host
waits on the card."""

from portbench import spans


def read(ctx):
    s = spans.per_call(ctx)
    if s is None:
        return None
    return s["spans"].get("sync", 0) / s["calls"]

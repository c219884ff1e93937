"""The bytes the program counts as copied between host and card
(``h2d_bytes`` and ``d2h_bytes``, 10^9) over the seconds of the traced
calls' ``Memcpy HtoD`` and ``Memcpy DtoH`` records."""

from portbench import spans


def read(ctx):
    s = spans.per_call(ctx)
    if s is None:
        return None
    moved = s["counters"].get("h2d_bytes", 0) + s["counters"].get(
        "d2h_bytes", 0)
    copy_s = sum(c["copy_s"] for c in ctx.trace["calls"])
    if moved <= 0 or copy_s <= 0:
        return None
    return moved / copy_s / 1e9

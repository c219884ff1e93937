"""The device compute's share of its roofline, in %: the least time the
traced calls' work needs on the card, each call's compressed and decoded
bytes moved once at the card's HBM bandwidth (``peaks.json``), over the
time of their kernel records (copies between host and card left out).
The work is reckoned from the calls' inputs and outputs, whatever
kernels do it.  No number for a card the table lacks, or no kernel."""

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "peaks.json")


def read(ctx):
    if ctx.trace is None:
        return None
    with open(PEAKS) as f:
        peak = json.load(f).get(ctx.device_kind)
    calls = ctx.trace["calls"]
    kernel_s = sum(c["kernel_s"] for c in calls)
    if not peak or kernel_s <= 0:
        return None
    least = sum(c["decoded"] + c["encoded"] for c in calls) / peak[
        "hbm_bytes_per_s"]
    return 100.0 * least / kernel_s

"""Run a call of the port under a CPU-only ``torch.profiler`` session and
read back the span records of its request (``tpucomp_torch.stats``)."""

from torch.profiler import ProfilerActivity, profile

from tpucomp_torch import stats


def traced(call):
    """``call()`` with the span records cleared and a CPU profiler on:
    returns its result (or the exception it raised) and the records of its
    last request, in order."""
    stats.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        try:
            out = call()
        except Exception as e:  # noqa: BLE001 - the caller checks it
            out = e
    records = stats.spans()
    roots = [r for r in records if r.parent is None]
    if not roots:
        return out, []
    last = roots[-1].request
    return out, [r for r in records if r.request == last]


def totals(records) -> dict:
    """The records' counters, summed by name."""
    out = {}
    for r in records:
        for name, n in r.counters.items():
            out[name] = out.get(name, 0) + n
    return out


def names(records, kind=None) -> set:
    return {r.name for r in records if kind is None or r.kind == kind}

"""The program's own records of the traced calls, reduced per call: what
the readers of ``staging_ms_per_call``, ``launch_ms_per_call``,
``sync_wait_ms_per_call``, ``syncs_per_call``, ``copy_GBps`` and
``merge_steps_per_call`` read.

``tpucomp_torch.stats.spans()`` holds a record of every span the program
opened while a profiler session recorded, and the harness runs its
session only around the traced calls, so the records are those calls'.
A call is a request whose root span is an ``api.*`` call span; a span's
self time is its time less that of its children.  A version of the
program that keeps no records gives no summary, and its readers no
number.
"""

from __future__ import annotations

API = "api."


def records():
    """The program's span records, or None where it keeps none."""
    try:
        from tpucomp_torch import stats
    except ImportError:
        return None
    read = getattr(stats, "spans", None)
    return None if read is None else read()


def summary(recs) -> dict | None:
    """Over the requests rooted in an ``api.*`` span: ``calls`` (their
    number), and by span kind ``self_s`` (self seconds), ``total_s``
    (seconds) and ``spans`` (how many); ``counters`` summed by name.
    None without such a request."""
    if not recs:
        return None
    roots = {r.request for r in recs
             if r.parent is None and r.name.startswith(API)}
    if not roots:
        return None
    child_s = [0.0] * len(recs)
    for r in recs:
        if r.parent is not None:
            child_s[r.parent] += (r.end_ns - r.start_ns) * 1e-9
    out = {"calls": len(roots), "self_s": {}, "total_s": {}, "spans": {},
           "counters": {}}
    for r, inner in zip(recs, child_s):
        if r.request not in roots:
            continue
        s = (r.end_ns - r.start_ns) * 1e-9
        out["self_s"][r.kind] = out["self_s"].get(r.kind, 0.0) + s - inner
        out["total_s"][r.kind] = out["total_s"].get(r.kind, 0.0) + s
        out["spans"][r.kind] = out["spans"].get(r.kind, 0) + 1
        for name, n in r.counters.items():
            out["counters"][name] = out["counters"].get(name, 0) + n
    return out


def per_call(ctx) -> dict | None:
    """:func:`summary` of the program's records after a traced run."""
    if ctx.trace is None:
        return None
    return summary(records())

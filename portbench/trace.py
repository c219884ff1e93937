"""The traced run: a ``torch.profiler`` session over the clients' calls,
and its reduction to what the per-layer readers read.

A profiler session on the card loses its first device records once the
process has run a while, so each session opens with ``PRIMER_LAUNCHES``
small kernels under a ``PRIMER`` annotation, and the launches after them
that still have no device record are counted (``lost``).  That is a
copy of the port's own check, kept here so that the yardstick does not
move with the program.

The session records every thread of the process: each client's calls sit
in a ``portbench.call.<client>`` annotation on its own thread, and the
stretch the clients run in a ``portbench.window`` annotation on the main
thread.  A device record (kernel, copy, memset) belongs to the client
whose thread launched it (by the runtime call of the same correlation
id), and to the call that was running on that thread when it launched.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

PRIMER_LAUNCHES = 1024
PRIMER = "device_trace primer"
WINDOW = "portbench.window"
CALL = "portbench.call."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_COPIES = ("Memcpy HtoD", "Memcpy DtoH")


def lost_launches(events: list) -> list:
    """The kernel launches (CUDA runtime records) after the primer's
    annotation that have no kernel record of the same correlation id."""
    end = max((e["ts"] + e.get("dur", 0) for e in events
               if e.get("cat") == "user_annotation"
               and e.get("name") == PRIMER), default=float("-inf"))
    kernels = {e["args"].get("correlation") for e in events
               if e.get("cat") == "kernel" and "args" in e}
    return [e for e in events
            if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e["name"]
            and e["ts"] > end
            and e.get("args", {}).get("correlation") not in kernels]


@contextlib.contextmanager
def session(device, events: list):
    """Profile the block on ``device`` (every thread, host and card);
    append the Chrome trace's events to ``events`` when it ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=config)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.start()
        try:
            with record_function(PRIMER):
                x = torch.zeros(1, device=device)
                for _ in range(PRIMER_LAUNCHES):
                    x.add_(1)
                torch.cuda.synchronize(device)
            yield
            torch.cuda.synchronize(device)
        finally:
            prof.stop()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events.extend(json.load(f)["traceEvents"])
    finally:
        os.remove(path)


def _union(spans: list) -> list:
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(merged: list, s: float, e: float) -> float:
    return sum(max(0.0, min(e, b) - max(s, a)) for a, b in merged)


def _short(name: str) -> str:
    """A kernel's name without its return type, arguments and template
    arguments."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0]
    return name.removeprefix("void ").strip()[:100]


class _Ops:
    """The host ops (``cpu_op``) of one thread, to find the innermost one
    running at a time."""

    def __init__(self, ops: list):
        self.ops = sorted(ops)
        self.starts = [o[0] for o in self.ops]

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t)
        best = None
        for s, e, name in reversed(self.ops[max(0, i - 64):i]):
            if s <= t <= e and (best is None or s > best[0]):
                best = (s, e, name)
        return best[2] if best else None


def summarize(events: list, works: dict) -> dict:
    """The traced stretch reduced to per-call records and the device's
    busy time.

    ``works`` maps each client to the list of its traced calls' work,
    ``(decoded bytes, encoded bytes)``, in order.  Returns ``calls``
    (each with its client, seconds in the call's span, seconds of it in
    which the client had no device record (``host_s``), seconds of
    host-card copies, seconds of kernels, kernel records, and its work),
    ``busy_s`` and ``window_s`` (the union of all device records in the
    window annotation, and its length), ``lost`` (launches with no
    device record), and ``breakdown`` (device ops and idle gaps).
    """
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} {WINDOW} annotations")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith(CALL):
            spans.setdefault(int(e["name"][len(CALL):]), []).append(
                (e["ts"], e["ts"] + e["dur"], e["tid"]))
    if sorted(spans) != sorted(works) or any(
            len(spans[c]) != len(works[c]) for c in works):
        raise RuntimeError("the trace lacks client calls: "
                           f"{ {c: len(s) for c, s in spans.items()} }")
    client_of_tid = {s[2]: c for c, ss in spans.items() for s in ss}
    launch = {}
    ops_by_tid = {}
    for e in events:
        cat = e.get("cat")
        if cat in ("cuda_runtime", "cuda_driver") and "args" in e:
            launch[e["args"].get("correlation")] = (e["tid"], e["ts"])
        elif cat == "cpu_op":
            ops_by_tid.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
    ops = {tid: _Ops(o) for tid, o in ops_by_tid.items()}
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    per_call = {c: [[] for _ in ss] for c, ss in spans.items()}
    op_time = {}
    for e in dev:
        corr = e.get("args", {}).get("correlation")
        tid, t = launch.get(corr, (None, None))
        name = _short(e["name"])
        if tid in ops and e["cat"] == "kernel":
            aten = ops[tid].at(t)
            if aten:
                name = f"{name} [{aten}]"
        op_time[name] = op_time.get(name, 0.0) + e["dur"] * 1e-6
        c = client_of_tid.get(tid)
        if c is None:
            continue
        ss = spans[c]
        k = bisect.bisect_right([s[0] for s in ss], t) - 1
        if k >= 0 and t <= ss[k][1]:
            per_call[c][k].append(e)
    calls = []
    for c, ss in sorted(spans.items()):
        for (s, e, _), recs, (dec, enc) in zip(ss, per_call[c], works[c]):
            merged = _union([(r["ts"], r["ts"] + r["dur"]) for r in recs])
            kernels = [r for r in recs if r["cat"] == "kernel"]
            calls.append({
                "client": c, "span_s": (e - s) * 1e-6,
                "host_s": (e - s - _covered(merged, s, e)) * 1e-6,
                "copy_s": sum(r["dur"] for r in recs
                              if r["name"].startswith(HOST_COPIES)) * 1e-6,
                "kernel_s": sum(r["dur"] for r in kernels) * 1e-6,
                "launches": len(kernels), "decoded": dec, "encoded": enc})
    busy = _union([(max(w0, e["ts"]), min(w1, e["ts"] + e["dur"]))
                   for e in dev if e["ts"] < w1 and e["ts"] + e["dur"] > w0])
    gaps, at = {}, w0
    for a, b in busy + [[w1, w1]]:
        if a > at:
            gaps.setdefault(_gap_name(at, a, spans, ops), []).append(a - at)
        at = max(at, b)
    idle = sorted(((n, sum(g) * 1e-6) for n, g in gaps.items()),
                  key=lambda x: -x[1])
    return {"calls": calls,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": (w1 - w0) * 1e-6,
            "lost": len(lost_launches(events)),
            "breakdown": {
                "device_ops": sorted(op_time.items(), key=lambda x: -x[1])[:10],
                "idle_gaps": idle[:10]}}


def _gap_name(a: float, b: float, spans: dict, ops: dict) -> str:
    """What the host was doing in the idle gap [a, b): the host op on a
    client's thread running at its middle, else the benchmark's span."""
    mid = (a + b) / 2
    names = []
    for c, ss in sorted(spans.items()):
        for s, e, tid in ss:
            if s <= mid <= e:
                op = ops[tid].at(mid) if tid in ops else None
                names.append(op or "portbench.call (no aten op)")
    return " + ".join(sorted(set(names))) or "between calls"

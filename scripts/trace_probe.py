"""Does ``stats.device_trace`` keep recording the card's kernels over a
long-lived process?

Takes ``device_trace`` traces of one LZNT1 ``ShardedCodec.decompress`` of
8 MiB, again and again in one process, and prints a JSON line a trace:
seconds since the process started, the trace's device records (kernels,
copies, sets), its CUDA runtime records, the median and range of the
delay from a launch to its kernel (by correlation id), and where the
first and last runtime, device and host records lie against the trace's
capture window (kineto's "Trace" span: us after its start, us after its
end).  Between traces the
card is kept busy with ``ShardedCodec.compress`` calls for ``--gap``
seconds, and every ``--events-every`` traces a ``torch.profiler`` session
read through ``prof.events()`` is taken as well.  ``--pad-ms`` and
``--primer`` take each trace in a session that first sleeps or launches
small kernels before the decompress.

    python3 scripts/trace_probe.py --traces 40 --gap 0
    python3 scripts/trace_probe.py --traces 24 --gap 25
    TEARDOWN_CUPTI=0 python3 scripts/trace_probe.py --traces 24 --gap 25
    python3 scripts/trace_probe.py --traces 24 --gap 25 --first-session 2
    python3 scripts/trace_probe.py --traces 24 --gap 25 --pad-ms 50
    python3 scripts/trace_probe.py --traces 24 --gap 25 --primer 256
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STARTED = time.perf_counter()


DECODE_KERNELS = ("lznt1_parse_kernel", "fill_records_kernel",
                  "resolve_near_kernel", "far_level_kernel")


def trace_once(sc, archive, pad_ms: float = 0.0, primer: int = 0) -> dict:
    """One ``device_trace`` of the decompress; with ``pad_ms`` or
    ``primer``, a ``torch.profiler`` session like it that first sleeps
    ``pad_ms`` or launches ``primer`` small kernels (then synchronises)
    before the decompress."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpucomp_torch.stats import device_trace

    logdir = tempfile.mkdtemp()
    try:
        if pad_ms or primer:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                x = torch.zeros(1, device="cuda")
                for _ in range(primer):
                    x.add_(1)
                torch.cuda.synchronize()
                time.sleep(pad_ms / 1e3)
                sc.decompress(archive)
                torch.cuda.synchronize()
            prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        else:
            with device_trace(logdir):
                sc.decompress(archive)
        (name,) = os.listdir(logdir)
        with open(os.path.join(logdir, name)) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(logdir)
    cats = collections.Counter(e.get("cat") for e in events)
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    delays = [e["ts"] - launch[e["args"]["correlation"]]["ts"]
              for e in device
              if e.get("args", {}).get("correlation") in launch]
    host = [e["ts"] for e in events if e.get("cat") == "cpu_op"]
    # the capture window (kineto's "Trace" span) against the records
    (win,) = [e for e in events if e.get("cat") == "Trace"] or [None]
    rts = [e["ts"] for e in launch.values()]
    edge = {}
    if win is not None:
        for label, ts in (("runtime", rts), ("device", [e["ts"] for e in device]),
                          ("host", host)):
            if ts:
                edge[f"{label}_first_us"] = round(min(ts) - win["ts"], 1)
                edge[f"{label}_last_us"] = round(
                    max(ts) - win["ts"] - win["dur"], 1)
    names = " ".join(e["name"] for e in events if e.get("cat") == "kernel")
    return {"device_records": len(device),
            "decode_kernels": sum(k in names for k in DECODE_KERNELS),
            "runtime_records": cats.get("cuda_runtime", 0),
            "kernels": sorted({e["name"][:40] for e in events
                               if e.get("cat") == "kernel"})[:6],
            "delay_us_median": statistics.median(delays) if delays else None,
            "delay_us_min": min(delays) if delays else None,
            "delay_us_max": max(delays) if delays else None,
            "host_span_us": (max(host) - min(host)) if host else None,
            **edge}


def events_once(sc, archive) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sc.decompress(archive)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--traces", type=int, default=20)
    ap.add_argument("--gap", type=float, default=0.0)
    ap.add_argument("--events-every", type=int, default=4)
    ap.add_argument("--pad-ms", type=float, default=0.0)
    ap.add_argument("--primer", type=int, default=0)
    ap.add_argument("--first-session", type=float, default=0.0,
                    help="seconds of a first, idle profiler session")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from benchmarks.corpus import silesia_like
    from tpucomp_torch.dist import ShardedCodec, data_mesh
    from tpucomp_torch.kernels import _build

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    _build.build()
    data = silesia_like(8 << 20)
    sc = ShardedCodec("lznt1", mesh=data_mesh())
    archive = sc.compress(data)
    if args.first_session:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            time.sleep(args.first_session)
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
    for k in range(args.traces):
        row = {"trace": k, "s": round(time.perf_counter() - STARTED, 3)}
        row.update(trace_once(sc, archive, args.pad_ms, args.primer))
        if args.events_every and k % args.events_every == 0:
            row["events_device_records"] = events_once(sc, archive)
        print(json.dumps(row), flush=True)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.gap:
            sc.compress(data)
        torch.cuda.synchronize()


if __name__ == "__main__":
    main()

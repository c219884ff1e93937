"""Per-run stats and an optional profiler scope: ``tpucomp.stats``.

``RunStats`` and ``timed`` are tpucomp's.  ``device_trace`` is a
``torch.profiler`` scope in place of ``jax.profiler``'s: it records the
host's ops, and the device's kernels and copies once CUDA is initialised,
and writes one Chrome trace file into ``logdir``.

A profiler session on the card loses its first device records (kernels,
copies) once the process has run for a while: on an NVIDIA H100 the
loss grew by one record every 12-13 s of a process kept busy between
traces, whatever the time between the session's start and its first
launch, and a session that first launched 256 small kernels lost only
those (``scripts/trace_probe.py``).  So ``device_trace`` opens each
session on the card with ``PRIMER_LAUNCHES`` small kernels under a
``PRIMER`` annotation, and warns when a kernel launched after them still
has no device record in the trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class RunStats:
    fmt: str = ""
    in_bytes: int = 0
    out_bytes: int = 0
    units: int = 0
    stored_raw_units: int = 0
    wall_s: float = 0.0

    @property
    def ratio(self) -> float:
        return self.out_bytes / self.in_bytes if self.in_bytes else 0.0

    @property
    def gbps(self) -> float:
        return self.in_bytes / self.wall_s / 1e9 if self.wall_s else 0.0

    def as_dict(self) -> Dict:
        return {
            "fmt": self.fmt,
            "in_bytes": self.in_bytes,
            "out_bytes": self.out_bytes,
            "units": self.units,
            "stored_raw_units": self.stored_raw_units,
            "wall_s": round(self.wall_s, 6),
            "ratio": round(self.ratio, 6),
            "GBps": round(self.gbps, 6),
        }


@contextlib.contextmanager
def timed(stats: RunStats):
    t0 = time.perf_counter()
    try:
        yield stats
    finally:
        stats.wall_s += time.perf_counter() - t0


# the small kernels that open a session on the card (see the module's
# docstring), and their annotation in the trace
PRIMER_LAUNCHES = 1024
PRIMER = "device_trace primer"


def lost_launches(events: List[dict]) -> List[dict]:
    """The kernel launches (CUDA runtime records) after the primer's
    annotation in a Chrome trace's ``events`` that have no kernel record
    of the same correlation id."""
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
def device_trace(logdir: Optional[str] = None, device=None):
    """``torch.profiler`` scope writing ``logdir/trace-<pid>-<ns>.json``
    (Chrome trace format) when a logdir is given; nothing otherwise.
    Once CUDA is initialised it also records the card's work: the
    session opens with the primer on ``device`` (the current CUDA device
    when None; no primer for a CPU device), and a ``RuntimeWarning``
    names the launches that still have no device record."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_initialized()
    if device is None and cuda:
        device = torch.device("cuda", torch.cuda.current_device())
    primed = cuda and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        if primed:
            with record_function(PRIMER):
                x = torch.zeros(1, device=device)
                for _ in range(PRIMER_LAUNCHES):
                    x.add_(1)
                torch.cuda.synchronize(device)
        yield
        if cuda:
            torch.cuda.synchronize()
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
    if primed:
        with open(path) as f:
            lost = lost_launches(json.load(f)["traceEvents"])
        if lost:
            warnings.warn(f"device_trace: {len(lost)} kernel launches have "
                          f"no device record in {path} (the profiler "
                          "dropped them)", RuntimeWarning, stacklevel=3)

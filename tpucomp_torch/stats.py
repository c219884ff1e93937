"""Per-run stats, an optional profiler scope (``tpucomp.stats``), and the
port's spans and counters.

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

Spans and counters inside the port (:func:`span`, :func:`count`) record
only while a ``torch.profiler`` session records (``device_trace``, or any
other), and cost one read of the profiler's flag otherwise.  A span then
emits a host op of its name into the profiler's trace, beside the aten
ops, kernels and copies it holds, and keeps a record in memory
(:func:`spans`): its name and kind, thread, start and end on
``time.time_ns()`` (the clock of the trace's ``ts`` plus its
``baseTimeNanoseconds``), its parent, the request it belongs to (every
span opened under one outermost span, the API call), and the counters
added while it was the innermost span.  Kinds:

* ``call``: a public entry point, the root of a request;
* ``stage``: host steps over bytes (Python and NumPy);
* ``compute``: the host issuing device work (kernels, plain torch ops);
* ``copy``: a host-to-card copy (counts ``h2d_bytes``);
* ``sync``: the host blocked on the card, a copy back included (counts
  ``d2h_bytes``).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler


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


# -- spans and counters --------------------------------------------------

KINDS = ("call", "stage", "compute", "copy", "sync")
# records a thread keeps; the spans past them are counted in ``dropped``
MAX_RECORDS = 1 << 16
dropped = 0

_local = threading.local()
_stores: list = []  # every thread's _Store, for spans() and clear()
_lock = threading.Lock()
_requests = itertools.count(1)


class Span(NamedTuple):
    """One span's record (:func:`spans`): ``parent`` is the index of its
    parent in the same list (None for a request's root); ``counters``
    are those added while it was the innermost open span."""
    name: str
    kind: str
    thread: int
    start_ns: int
    end_ns: int
    parent: Optional[int]
    request: int
    counters: Dict[str, int]


class _Record:
    __slots__ = ("name", "kind", "start", "end", "parent", "request",
                 "counters")

    def __init__(self, name, kind, start, parent, request):
        self.name, self.kind, self.start = name, kind, start
        self.end, self.parent, self.request = start, parent, request
        self.counters = None


class _Store:
    """One thread's records and its open spans (a record, or None for a
    span past ``MAX_RECORDS``, with the request it belongs to)."""

    def __init__(self):
        self.thread = threading.get_native_id()
        self.alive = threading.current_thread().is_alive
        self.records = []
        self.stack = []


def _store() -> _Store:
    try:
        return _local.store
    except AttributeError:
        store = _local.store = _Store()
        with _lock:
            _stores.append(store)
        return store


class span:
    """``with span(name, kind):`` records the block (see the module's
    docstring) while a profiler session records; otherwise it reads one
    flag and records nothing.  ``@span(name, kind)`` records each call of
    a function, its locals' release included."""

    __slots__ = ("name", "kind", "_rf", "_store")

    def __init__(self, name: str, kind: str):
        self.name = name
        self.kind = kind

    def __enter__(self):
        if not _profiler._is_profiler_enabled:
            self._rf = None
            return self
        global dropped
        store = self._store = _store()
        stack = store.stack
        if stack:
            parent, request = stack[-1]
        else:
            parent, request = None, next(_requests)
        if len(store.records) < MAX_RECORDS:
            rec = _Record(self.name, self.kind, 0, parent, request)
            store.records.append(rec)
        else:
            rec = None
            with _lock:
                dropped += 1
        stack.append((rec, request))
        self._rf = _RecordFunctionFast(self.name)
        self._rf.__enter__()
        # the clock is read after every allocation above: a garbage
        # collection one of them sets off (hundreds of ms on a large heap)
        # would otherwise fall between the span's start and its op's
        if rec is not None:
            rec.start = rec.end = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self._rf is None:
            return False
        self._rf.__exit__(None, None, None)
        rec, _ = self._store.stack.pop()
        if rec is not None:
            rec.end = time.time_ns()
        return False

    def __call__(self, fn):
        name, kind = self.name, self.kind

        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, kind):
                return fn(*args, **kwargs)
        return call


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of this thread's innermost open span
    while a profiler session records; nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return
    stack = _store().stack
    if stack and stack[-1][0] is not None:
        rec = stack[-1][0]
        if rec.counters is None:
            rec.counters = {}
        rec.counters[name] = rec.counters.get(name, 0) + n


def launched(fn, n: int = 1) -> None:
    """A kernel wrapper ``fn`` launched ``n`` kernels: adds them to
    ``fn.launches`` (every thread's) and, while a profiler session
    records, to the counter ``launches.<fn's name>`` of the open span."""
    with _lock:
        fn.launches += n
    if _profiler._is_profiler_enabled:
        count("launches." + fn.__name__, n)


def spans() -> List[Span]:
    """Every thread's records, parents before their children; nothing is
    cleared."""
    with _lock:
        stores = list(_stores)
    out = []
    for store in stores:
        recs = list(store.records)
        index = {id(r): len(out) + k for k, r in enumerate(recs)}
        out.extend(Span(r.name, r.kind, store.thread, r.start, r.end,
                        None if r.parent is None
                        else index.get(id(r.parent)),
                        r.request, dict(r.counters or {}))
                   for r in recs)
    return out


def clear() -> None:
    """Drop every record and the ``dropped`` count (call it with no span
    open)."""
    global dropped
    with _lock:
        for store in _stores:
            store.records = []
        _stores[:] = [s for s in _stores if s.alive() or s.stack]
        dropped = 0

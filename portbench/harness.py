"""One run of one cell: set-up, a closed loop of API calls, the check.

The program under test is ``tpucomp_torch`` and nothing else: a cell's
``api`` names one of its public calls (``compress``, ``decompress``,
``compress_batch``, ``decompress_batch``), which the clients call on the
cell's inputs.  Everything else here, from the inputs to the check, is
the benchmark's own.

A run is one process.  Its clients are threads, each with its own CUDA
stream, so that one process drives the card, as a worker pool in one
process shares it.  Set-up makes the pool of inputs (in helper
processes that never touch the card), warms every input through the
program on every client, and ends at the barrier that starts the
window.  Each client then calls the program in a closed loop, one input
of the pool after another, until the window closes; a call that has not
returned by then is not counted.  With ``trace``, each client instead
makes ``trace_calls`` calls under the profiler.

After the window, the outputs are compared with the plain reference
(``portbench.ref``): a read call's output with the data the frozen
encoder was given, a write call's output as the reference reads it back.
"""

from __future__ import annotations

import contextlib
import itertools
import multiprocessing
import os
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np

from . import frozen, inputs, ref, spec, trace
from .data import gen

FORBIDDEN = ("jax", "jaxlib", "flax", "tpucomp")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is one the benchmark may
    not load (``tpucomp_torch`` is not ``tpucomp``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def program(api: str, fmt: str, self_terminating: bool, device):
    """The call of ``tpucomp_torch`` that the cell's window drives, as a
    function of one pool input."""
    import tpucomp_torch as tt

    if api == "compress":
        return lambda x: tt.compress(fmt, x["arg"], device=device)
    if api == "compress_batch":
        return lambda x: tt.compress_batch(fmt, x["arg"], device=device)
    if api == "decompress":
        return lambda x: tt.decompress(
            fmt, x["arg"], None if self_terminating else len(x["expect"]),
            device=device)
    if api == "decompress_batch":
        return lambda x: tt.decompress_batch(fmt, *x["arg"], device=device)
    raise ValueError(f"unknown API entry {api!r}")


class Inputs:
    """The cell's pool of inputs, made in ``helpers`` processes (in this
    one with 0) from the moment of construction: the caller starts CUDA
    and the program meanwhile, then takes them with :meth:`get`."""

    def __init__(self, config: dict, cell: dict, seed: int, helpers: int,
                 root: str = spec.ROOT):
        jobs = [(config, cell, seed, k, root) for k in range(cell["pool"])]
        if cell["api"] in inputs.READS:
            frozen.build(root=root)
        self._pool = None
        if helpers < 1:
            self._made = [inputs.make(*j) for j in jobs]
            return
        self._pool = multiprocessing.get_context("spawn").Pool(helpers)
        self._pending = self._pool.starmap_async(inputs.make, jobs)

    def get(self) -> list:
        if self._pool is not None:
            try:
                self._made = self._pending.get()
            finally:
                self.close()
        return self._made

    def close(self) -> None:
        """Stop the helpers and wait for them to end."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None


def _encoded(out) -> int:
    return len(out) if isinstance(out, bytes) else sum(map(len, out))


def _wrong_bytes(got: bytes, want: bytes) -> int:
    a, b = np.frombuffer(got, np.uint8), np.frombuffer(want, np.uint8)
    n = min(len(a), len(b))
    return int(np.count_nonzero(a[:n] != b[:n])) + abs(len(a) - len(b))


class Tally:
    """The check's counts: answers (a returned file, or one unit of a
    batch) checked and wrong, their wrong bytes, and inputs wrong."""

    def __init__(self):
        self.checked = self.wrong = self.bytes = self.inputs_wrong = 0

    def answers(self, got: list, want: list) -> None:
        for k, w in enumerate(want):
            g = got[k] if got is not None and k < len(got) else None
            bad = len(w) if g is None else _wrong_bytes(g, w)
            self.checked += 1
            self.wrong += bad > 0
            self.bytes += bad
        if got is not None and len(got) > len(want):
            extra = got[len(want):]
            self.wrong += len(extra)
            self.bytes += sum(map(len, extra))


def _readback(fmt: str, streams: list, lens: list, root: str) -> list:
    """The reference's reading of ``streams``, a unit's answer None where
    the reference finds it malformed."""
    try:
        return ref.decode(fmt, streams, lens, root=root)
    except ValueError:
        if len(streams) == 1:
            return [None]
        return [r for s, n in zip(streams, lens)
                for r in _readback(fmt, [s], [n], root)]


def check(config: dict, cell: dict, seed: int, pool: list,
          outputs: list, root: str = spec.ROOT) -> Tally:
    """Compare the kept outputs, ``(pool index, output)`` pairs, with the
    reference of the configuration's format under ``root``."""
    fmt, api = config["format"], cell["api"]
    tally = Tally()
    if api in inputs.READS:
        for k, x in enumerate(pool):
            # the frozen encoder's streams mean the data: a seeded sample
            # of each input's units, read back by the reference
            pick = gen.rng_for(seed, 3000 + k).choice(
                len(x["units"]), min(cell["check_units"], len(x["units"])),
                replace=False)
            got = _readback(fmt, [x["streams"][i] for i in pick],
                            [len(x["units"][i]) for i in pick], root)
            want = [x["units"][i] for i in pick]
            tally.inputs_wrong += sum(g != w for g, w in zip(got, want))
        for k, out in outputs:
            want = pool[k]["expect"]
            if api == "decompress":
                tally.answers(None if out is None else [out], [want])
            else:
                tally.answers(out, want)
        return tally
    distinct = {}
    for k, out in outputs:
        seen = distinct.setdefault(k, [])
        if out is None:
            tally.answers(None, pool[k]["units"] if api == "compress_batch"
                          else [pool[k]["arg"]])
        elif all(out != d for d in seen):
            seen.append(out)
    for k, outs in sorted(distinct.items()):
        x = pool[k]
        for n, out in enumerate(outs):
            if api == "compress":
                tally.answers(_readback(fmt, [out], [len(x["arg"])], root),
                              [x["arg"]])
                continue
            units = x["units"]
            pick = gen.rng_for(seed, 4000 + 97 * k + n).choice(
                len(units), min(cell["check_units"], len(units)),
                replace=False)
            if len(out) != len(units):
                tally.answers(None, units)
                continue
            tally.answers(_readback(fmt, [out[i] for i in pick],
                                    [len(units[i]) for i in pick], root),
                          [units[i] for i in pick])
    return tally


def helpers_for(cell: dict) -> int:
    """Processes that make the inputs: one an input, at most the CPUs."""
    return min(cell["pool"], os.cpu_count() or 1)


def run(cell: dict, config: dict, e2e: list, layer: list, seed: int,
        seconds: float, traced: bool, device="cuda", call=None,
        t_start: float | None = None, made: Inputs | None = None,
        chips: int = 1, root: str = spec.ROOT) -> dict:
    """One run of the cell; returns the result line's object.

    ``call`` replaces the program's call (the tests plant faults with
    it); ``made`` is the pool of inputs, if already started (else it is
    made here, in this process); ``root`` is the benchmark's root, where
    the format's reference and frozen encoder and the metrics' readers
    are found.
    """
    import torch

    t_torch = time.perf_counter()
    t_start = time.perf_counter() if t_start is None else t_start
    if made is None:
        made = Inputs(config, cell, seed, 0, root)
    nc = cell["clients"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    try:
        # CUDA and the program start while the helpers make the inputs
        streams = [torch.cuda.Stream(dev) if cuda else None
                   for _ in range(nc)]
        if call is None:
            call = program(cell["api"], config["format"],
                           config.get("self_terminating", False), dev)
        t_cuda = time.perf_counter()
        print(f"portbench: torch imported at {t_torch - t_start:.3f} s",
              file=sys.stderr)
        pool = made.get()
    finally:
        made.close()
    t_inputs = time.perf_counter()
    npool = len(pool)
    warm_lock = threading.Lock()
    window = {}
    records = [[] for _ in range(nc)]
    outputs = [[] for _ in range(nc)]
    works = {c: [] for c in range(nc)}
    errors = []

    def start_window():
        window["t0"] = time.perf_counter()
        window["end"] = window["t0"] + seconds

    setup_done = threading.Barrier(nc + 1, action=start_window)
    go = threading.Barrier(nc + 1)
    done = threading.Barrier(nc + 1)

    def attempt(x):
        try:
            return call(x)
        except Exception as e:  # a failed call is counted, not raised
            errors.append(f"{type(e).__name__}: {e}")
            return None

    def client(c):
        try:
            _client(c)
        except BaseException:
            for b in (setup_done, go, done):
                b.abort()
            raise

    def _client(c):
        keep = gen.rng_for(seed, 1000 + c)
        with (torch.cuda.stream(streams[c]) if cuda
              else contextlib.nullcontext()):
            with warm_lock:
                warm_failed = sum(attempt(pool[(c + k) % npool]) is None
                                  for k in range(npool))
                if cuda:
                    torch.cuda.synchronize(dev)
            window.setdefault("warm_failed", []).append(warm_failed)
            setup_done.wait()
            if traced:
                go.wait()
                for i in range(cell["trace_calls"]):
                    k = (c + i) % npool
                    with torch.profiler.record_function(f"{trace.CALL}{c}"):
                        out = attempt(pool[k])
                    outputs[c].append((k, out))
                    x = pool[k]
                    works[c].append((x["decoded"], x.get("encoded")
                                     or (_encoded(out) if out else 0)))
                done.wait()
                return
            end = window["end"]
            for i in itertools.count():
                k = (c + i) % npool
                s = time.perf_counter()
                if s >= end:
                    break
                out = attempt(pool[k])
                t = time.perf_counter()
                if t > end:
                    break
                x = pool[k]
                records[c].append(SimpleNamespace(
                    start=s, end=t, ok=out is not None, pool=k,
                    decoded=x["decoded"] if out is not None else 0,
                    encoded=(x.get("encoded") or _encoded(out))
                    if out is not None else 0))
                if cell["api"] in inputs.WRITES or (
                        keep.random() < cell["check_share"]):
                    outputs[c].append((k, out))

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(nc)]
    for t in threads:
        t.start()
    setup_done.wait()
    setup_s = window["t0"] - t_start
    print(f"portbench: set-up {setup_s:.3f} s: CUDA and the program ready "
          f"at {t_cuda - t_start:.3f} s, the inputs at "
          f"{t_inputs - t_start:.3f} s, warm-up to the window "
          f"{window['t0'] - t_inputs:.3f} s", file=sys.stderr)
    events = []
    if traced:
        with trace.session(dev, events):
            with torch.profiler.record_function(trace.WINDOW):
                go.wait()
                done.wait()
    for t in threads:
        t.join()
    if cuda:
        torch.cuda.synchronize(dev)
        memory_peak = torch.cuda.max_memory_allocated(dev)
    else:
        memory_peak = 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: loaded {', '.join(found)}, which the "
                         "benchmark may not load")
    calls = [r for rs in records for r in rs]
    if calls:
        ms = sorted((r.end - r.start) * 1e3 for r in calls)
        print(f"portbench: {len(ms)} calls in the window, per call median "
              f"{ms[len(ms) // 2]:.3f} ms, min {ms[0]:.3f}, max {ms[-1]:.3f}",
              file=sys.stderr)
    kept = [o for os_ in outputs for o in os_]
    if cuda:
        torch.cuda.empty_cache()
    tally = check(config, cell, seed, pool, kept, root)
    failed = (sum(not r.ok for r in calls) if not traced
              else sum(out is None for _, out in kept))
    attempted = len(calls) if not traced else len(kept)
    warm_failed = sum(window.get("warm_failed", []))
    direction = "write" if cell["api"] in inputs.WRITES else "read"
    firsts = {}
    for k, out in kept:
        if out is not None:
            firsts.setdefault(k, _encoded(out))
    ctx = SimpleNamespace(
        direction=direction, seconds=seconds, setup_s=setup_s, calls=calls,
        device_kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
        pool_bytes=(sum(firsts.values()),
                    sum(pool[k]["decoded"] for k in firsts)),
        trace=trace.summarize(events, works) if traced else None)
    metrics = {}
    for m in (layer if traced else e2e):
        value = spec.reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = {
        "calls_failed": (failed + warm_failed, "<=", 0),
        "answers_wrong": (tally.wrong, "<=", 0),
        "bytes_wrong": (tally.bytes, "<=", 0),
        "answers_checked": (tally.checked, ">=", 1),
    }
    if direction == "read":
        limits["inputs_wrong"] = (tally.inputs_wrong, "<=", 0)
    correct = all(v <= lim if op == "<=" else v >= lim
                  for v, op, lim in limits.values())
    result = {
        "correct": correct, "attempted": attempted, "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else "cpu",
                   "count": chips, "memory_peak_bytes": memory_peak},
    }
    if traced:
        summary = ctx.trace
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
        result["lost_launches"] = summary["lost"]
    result["errors"] = errors[:3]
    result["check"] = {name: {"value": v, "limit": f"{op} {lim}"}
                       for name, (v, op, lim) in limits.items()}
    return result

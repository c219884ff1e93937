#!/usr/bin/env python3
"""Smoke run of tpucomp_torch on one NVIDIA GPU: LZNT1 decode and Xpress
Huffman (XH) batched decode end to end.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit code:

1. Device: the card's name and power limit.
2. Build: nvcc builds the port's CUDA kernels from ``tpucomp_torch/
   kernels/csrc``, one process per source, all at once.
3. LZNT1 kernel vs plain: each kernel against its plain PyTorch version on the
   same CUDA tensors at the main path's shape (one row per chunk of the
   corpus, 256 rows replaced by seeded malformed ones), equal exactly;
   then each one's time, CUDA-event timed after a warm-up.
4. LZNT1 main path: the 32 MiB corpus of benchmarks/corpus.py plus 64 KiB of
   seeded random bytes (so that chunks are stored raw) is encoded by the
   repo's native C encoder, decoded by ``tpucomp_torch.decompress`` and
   compared with the input, 64 sampled chunks also against the native C
   decoder; 512 units of 64 KiB go through ``decompress_batch``; a corrupt
   stream must raise ``DataError``.  Every kernel must have launched on
   this path.  Then decode GB/s, the median of 5 runs after a warm-up;
   ``decompress`` step by step; and one ``decompress`` under
   ``torch.profiler``: the device's busy time and idle share, and the
   device ops that take the most time.
5. XH kernel vs plain: the corpus's 512 units of 64 KiB, one of seeded
   random bytes and one of zeros, each encoded by the native C XH
   encoder, plus 32 seeded malformed units, in one batch of 546 rows.
   Every XH kernel against its plain version on the same CUDA tensors,
   equal exactly, and both times.  The parse's plain version loops once
   per body byte, so it runs on a sub-batch of short rows (the shortest
   corpus streams and the malformed rows), and the kernel with it.
6. XH main path, with every launch count set to 0 first:
   ``decompress_batch("xpress_huff", ...)`` of the 514 units, equal to
   them (16 sampled units also to the native C decoder); the same units
   encoded as resolved archives (depth 2) through ``decompress_units(...,
   fast_resolve=True)``; a corrupt unit must raise ``DataError``; every XH
   kernel must have launched.  Then GB/s of ``decode_batch`` (resident)
   and ``decompress_batch``, the median of 5; the host steps; the device
   stages; peak memory; and one ``decompress_batch`` under the profiler.

The last two lines are JSON: the kernels, and ``{"ok": true, "device":
...}``.  The script exits nonzero, printing neither, when CUDA is absent.
It never imports JAX or the tpucomp package: it builds the native C codec
from its source with the host C compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
CORPUS_BYTES = 32 << 20
RANDOM_TAIL = 64 << 10
UNIT = 64 << 10  # NTFS's LZNT1 compression unit
N_MALFORMED = 256
N_XH_MALFORMED = 32
XH_SUB_SHORTEST = 32  # corpus streams in the plain parse's sub-batch


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 1) -> list[float]:
    """Per-call device times in ms, one CUDA-event pair per call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def clock(steps: dict, name: str, fn):
    """Run ``fn`` and synchronise; append its host-clock ms to
    ``steps[name]``.  Returns what ``fn`` returned."""
    import torch

    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    steps.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
    return res


class Native:
    """The repo's native C codec (tpucomp/native), built with the host C
    compiler into the port's build directory and bound by ctypes: LZNT1
    and Xpress Huffman encode and decode."""

    OPT_RESOLVE_OFFSETS = 1  # tpucomp_native.c OPT_*

    def __init__(self):
        from tpucomp_torch.kernels import _build

        src = os.path.join(ROOT, "tpucomp", "native", "tpucomp_native.c")
        cc = shutil.which("cc") or shutil.which("gcc")
        require(cc is not None, "no C compiler (cc or gcc) on PATH")
        lib_path, _ = _build.shared_library(cc, ["-O3", "-fPIC", "-shared"],
                                            [src], "tpucomp_native")
        self.lib = lib = ctypes.CDLL(lib_path)
        for fn in (lib.lznt1_compress, lib.lznt1_decompress,
                   lib.xh_compress, lib.xh_decompress):
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                           ctypes.c_int]
            fn.restype = ctypes.c_int
        lib.xh_compress_opt.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_int]
        lib.xh_compress_opt.restype = ctypes.c_int

    @staticmethod
    def _call(fn, data: bytes, cap: int, *extra) -> bytes:
        out = ctypes.create_string_buffer(cap)
        n = fn(data, len(data), out, cap, *extra)
        require(n >= 0, f"native codec returned {n}")
        return out.raw[:n]

    def lznt1_compress(self, data: bytes) -> bytes:
        bound = len(data) + 2 * (len(data) // 4096 + 2) + 16
        return self._call(self.lib.lznt1_compress, data, bound)

    def lznt1_decompress(self, data: bytes, out_len: int) -> bytes:
        return self._call(self.lib.lznt1_decompress, data, out_len)

    @staticmethod
    def _xh_bound(n: int) -> int:
        return max(1, (n + 65535) // 65536) * 264 + 2 * n + 16

    def xh_compress(self, data: bytes) -> bytes:
        return self._call(self.lib.xh_compress, data, self._xh_bound(len(data)))

    def xh_compress_opt(self, data: bytes, flags: int) -> bytes:
        return self._call(self.lib.xh_compress_opt, data,
                          self._xh_bound(len(data)), flags)

    def xh_decompress(self, data: bytes, out_len: int) -> bytes:
        return self._call(self.lib.xh_decompress, data, out_len)


def profile_device(label: str, fn) -> None:
    """One call of ``fn`` under ``torch.profiler``: the call's wall time on
    the host clock (the profiler stretches it), the device's busy time
    (the union of its kernel and copy intervals), its idle share of the
    wall, and the device ops with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    require(bool(spans), "torch.profiler recorded no device activity")
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3
    print(f"{label} under torch.profiler: wall {wall_ms:.4f} ms, device "
          f"busy {busy_ms:.4f} ms (idle {100 * (1 - busy_ms / wall_ms):.2f}% "
          f"of the wall), first to last device event "
          f"{(spans[-1][1] - spans[0][0]) / 1e3:.4f} ms")
    top = sorted((e for e in prof.key_averages()
                  if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"  device {e.self_device_time_total / 1e3:.4f} ms in "
              f"{e.count} calls: {e.key}")


def chunk_spans(stream: bytes) -> list[tuple[int, int]]:
    """(start, end) of every chunk, header included, in an LZNT1 stream."""
    spans, i = [], 0
    while i + 2 <= len(stream):
        header = stream[i] | (stream[i + 1] << 8)
        if header == 0:
            break
        end = i + 2 + (header & 0xFFF) + 1
        spans.append((i, end))
        i = end
    return spans


def malformed_rows(payload, plen, is_comp, rng):
    """Overwrite N_MALFORMED seeded rows of a batch with malformed chunks:
    random bytes, compressed chunks cut short, and copies before the chunk
    start.  Returns the row indices."""
    import torch

    N = payload.shape[0]
    rows = torch.from_numpy(rng.choice(N, N_MALFORMED, replace=False))
    for k, r in enumerate(rows.tolist()):
        kind = k % 3
        if kind == 0:  # random bytes, any length
            n = int(rng.integers(1, 4097))
            payload[r] = 0
            payload[r, :n] = torch.from_numpy(
                rng.integers(0, 256, n, dtype=np.uint8))
            plen[r] = n
        elif kind == 1:  # a compressed chunk cut anywhere
            plen[r] = int(rng.integers(1, max(int(plen[r]), 2)))
        else:  # a first token that copies from before the chunk start
            payload[r, :3] = torch.tensor([1, 0, 0], dtype=torch.uint8)
            plen[r] = max(int(plen[r]), 3)
        is_comp[r] = True
    return rows


def xh_malformed(native, units, streams, idx, rng):
    """N_XH_MALFORMED seeded malformed (stream, out_len) rows made from the
    units ``idx``: bodies cut short, flipped body bits, random code
    lengths, an out_len past the content, streams shorter than the table."""
    rows = []
    for k in range(N_XH_MALFORMED):
        i = idx[k % len(idx)]
        s, n = streams[i], len(units[i])
        kind = k % 5
        if kind == 0:
            rows.append((s[:int(rng.integers(257, len(s) // 2))], n))
        elif kind == 1:
            b = bytearray(s)
            for pos in rng.integers(256, len(s), 3).tolist():
                b[pos] ^= 1 << int(rng.integers(8))
            rows.append((bytes(b), n))
        elif kind == 2:  # short: such rows keep all 17 substeps busy
            rows.append((rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
                         + s[256:1800], n))
        elif kind == 3:
            rows.append((native.xh_compress(units[i][:n // 2]), n))
        else:
            rows.append((s[:int(rng.integers(1, 256))], n))
    return rows


def compare(name, got, want) -> int:
    """Max abs difference of two tensors or tuples of tensors; fails
    unless 0."""
    got, want = ((x,) if hasattr(x, "shape") else x for x in (got, want))
    require(len(got) == len(want), f"{name}: {len(got)} outputs against "
            f"{len(want)}")
    max_err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
    require(max_err == 0, f"{name} differs from its plain version "
            f"(max abs err {max_err})")
    return max_err


def xh_phases(dev, units, native, kernels) -> dict:
    """Phases 5 and 6, Xpress Huffman.  Adds the XH kernels' entries to
    ``kernels`` (and the XH comparisons of resolve_near and far_level to
    theirs) and returns the launches of every kernel on the XH main path."""
    import torch

    import tpucomp_torch
    from tpucomp_torch.codecs import xpress_huff as xh
    from tpucomp_torch.kernels import fill, gather, resolve, xh_parse
    from tpucomp_torch.kernels.common import SEG_LEVEL, SEG_LEVEL_CAP

    rng = np.random.default_rng(SEED + 1)
    units = list(units) + [
        rng.integers(0, 256, UNIT, dtype=np.uint8).tobytes(),  # tier 3
        bytes(UNIT)]  # tier 17
    t0 = time.perf_counter()
    streams = [native.xh_compress(u) for u in units]
    lens = [len(u) for u in units]
    sizes = sorted(len(x) for x in streams)
    print(f"xh: {len(units)} units of {UNIT} bytes (the corpus's "
          f"{len(units) - 2}, one of seeded random bytes, one of zeros) "
          f"encode to {sum(sizes)} "
          f"bytes (ratio {sum(sizes) / sum(lens)}), streams {sizes[0]} to "
          f"{sizes[-1]} bytes (median {sizes[len(sizes) // 2]}), "
          f"{time.perf_counter() - t0:.2f} s to encode")

    # ---- 5. kernel vs plain ---------------------------------------------------
    n_corpus = len(units) - 2
    shortest = sorted(range(n_corpus), key=lambda i: len(streams[i]))[
        :XH_SUB_SHORTEST]
    bad = xh_malformed(native, units, streams, shortest, rng)
    rows = list(zip(streams, lens)) + bad
    batch = xh.pack_units([r[0] for r in rows], [r[1] for r in rows], UNIT,
                          dev)
    N = batch[0].shape[0]
    tiers = {int(t): int(c) for t, c in zip(*torch.unique(
        batch[3], return_counts=True))}
    print(f"xh kernel vs plain at N={N} ({N_XH_MALFORMED} malformed rows), "
          f"payload width {batch[0].shape[1]}, substep tiers {tiers}")
    args = xh.parse_inputs(*batch)
    parsed = xh_parse.xh_parse(*args, UNIT)
    sub = torch.tensor(shortest + list(range(len(units), N)), device=dev)
    sub_args = tuple(a[sub] for a in args)
    sub_blen = int(sub_args[1].max())
    ref_out = []
    parse_plain_ms, = cuda_ms(lambda: ref_out.append(
        xh_parse.xh_parse_ref(*sub_args, UNIT)), reps=1, warmup=0)
    parsed_ref, = ref_out
    # the sub-batch alone, and its rows of the whole batch's launch
    parse_err = max(
        compare("xh_parse", xh_parse.xh_parse(*sub_args, UNIT), parsed_ref),
        compare("xh_parse", tuple(p[sub] for p in parsed), parsed_ref))
    parse_sub_ms = statistics.median(cuda_ms(
        lambda: xh_parse.xh_parse(*sub_args, UNIT), reps=5))
    parse_ms = statistics.median(cuda_ms(
        lambda: xh_parse.xh_parse(*args, UNIT), reps=5))
    print(f"xh_parse: equal to plain on a sub-batch of {len(sub)} rows (the "
          f"{XH_SUB_SHORTEST} shortest corpus streams and the malformed "
          f"rows, longest body {sub_blen} bytes): kernel {parse_sub_ms:.4f} "
          f"ms, plain {parse_plain_ms:.4f} ms; kernel on the whole batch "
          f"({N} rows, longest body {int(args[1].max())} bytes) "
          f"{parse_ms:.4f} ms")
    kernels.append({
        "name": "xh_parse", "route": "cuda",
        "source": "tpucomp_torch/kernels/csrc/xh_parse.cu",
        "replaces": "tpucomp/kernels/xh_pallas.py:371",
        "max_abs_err": parse_err, "ms": parse_sub_ms,
        "plain_ms": parse_plain_ms})

    rec_pos, rec_val, p_final, errk = parsed
    fill_in = (rec_pos, rec_val, UNIT, UNIT)
    filled = fill.fill_records_delta2(*fill_in)
    err = (errk != 0) | (filled[2] != 0) | (p_final < batch[2])
    require(not bool(err[:len(units)].any()),
            "a well-formed XH unit parsed with err set")
    print(f"xh: {int(err.sum())} rows with err ({N_XH_MALFORMED} malformed "
          f"rows injected)")
    near_in = xh.near_inputs(filled[0], filled[1])
    near = resolve.resolve_near(*near_in)
    seg_in = (near, SEG_LEVEL, SEG_LEVEL_CAP, False)
    seg = gather.far_level(*seg_in)
    probed = gather.far_probe(seg)
    row = gather.far_row(probed)
    torch.cuda.synchronize()
    tags = [int(((t & (1 << 24)) != 0).sum()) for t in (near, seg, probed)]
    print(f"xh far tags: {tags[0]} after the near walk, {tags[1]} after the "
          f"4 KiB level, {tags[2]} after the probes")
    cases = [
        ("fill_records", fill.fill_records_delta2,
         fill.fill_records_delta2_ref, fill_in, filled,
         "tpucomp/kernels/fill_pallas.py:180"),
        ("resolve_near", resolve.resolve_near, resolve.resolve_near_ref,
         near_in, (near,), None),
        ("far_level", gather.far_level, gather.far_level_ref, seg_in, (seg,),
         None),
        ("far_probe", gather.far_probe, gather.far_probe_ref, (seg,),
         (probed,), "tpucomp/kernels/gather_pallas.py:150"),
        ("far_row", gather.far_row, gather.far_row_ref, (probed,), (row,),
         "tpucomp/kernels/gather_pallas.py:315"),
    ]
    for name, fn, ref, fargs, got, replaces in cases:
        max_err = compare(name, got, ref(*fargs))
        ms = statistics.median(cuda_ms(lambda: fn(*fargs), reps=10))
        plain_ms = statistics.median(cuda_ms(lambda: ref(*fargs), reps=3))
        print(f"{name} (XH shape {list(fargs[0].shape)}): equal to plain; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if replaces is None:  # LZNT1's kernel: its entry has LZNT1's times
            entry = next(k for k in kernels if k["name"] == name)
            entry["max_abs_err"] = max(entry["max_abs_err"], max_err)
            continue
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpucomp_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms})
    del parsed, parsed_ref, filled, near_in, near, seg, probed, row, args
    del sub_args, rec_pos, rec_val, batch, fill_in, seg_in

    # ---- 6. main path ---------------------------------------------------------
    wrappers = (xh_parse.xh_parse, fill.fill_records_delta2,
                resolve.resolve_near, gather.far_level, gather.far_probe,
                gather.far_row)
    names = ("xh_parse", "fill_records", "resolve_near", "far_level",
             "far_probe", "far_row")
    t0 = time.perf_counter()
    resolved = [native.xh_compress_opt(u, Native.OPT_RESOLVE_OFFSETS | 2 << 8)
                for u in units]
    print(f"xh resolved archive streams (depth 2): {sum(map(len, resolved))} "
          f"bytes, {time.perf_counter() - t0:.2f} s to encode")
    corrupt = streams[0][:len(streams[0]) // 2]
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers:
        fn.launches = 0
    out = tpucomp_torch.decompress_batch("xpress_huff", streams, lens,
                                         device="cuda")
    out_res = xh.decompress_units(resolved, lens, fast_resolve=True,
                                  device="cuda")
    try:
        tpucomp_torch.decompress_batch("xpress_huff", [corrupt], [UNIT],
                                       device="cuda")
        raised = False
    except tpucomp_torch.DataError:
        raised = True
    launches = {n: fn.launches for n, fn in zip(names, wrappers)}
    print(f"xh main path launches: {launches}")
    require(out == units, "xh decompress_batch output differs from the units")
    for i in sorted(rng.choice(len(units), min(16, len(units)),
                               replace=False).tolist()):
        require(native.xh_decompress(streams[i], lens[i]) == out[i],
                f"xh unit {i} differs from the native C decoder")
    print(f"xh decompress_batch: {len(units)} units equal to the input; 16 "
          "sampled units equal to the native C decoder")
    require(out_res == units, "xh fast_resolve output differs from the units")
    print(f"xh decompress_units(fast_resolve=True): {len(units)} resolved "
          "archive units equal to the input")
    require(raised, "a corrupt XH unit did not raise DataError")
    print("xh corrupt unit: DataError raised")
    for n in names:
        require(launches[n] > 0, f"{n} never launched on the XH main path")
    print(f"xh peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    total = sum(lens)
    batch = xh.pack_units(streams, lens, UNIT, dev)
    res_batch = xh.pack_units(resolved, lens, UNIT, dev)
    timed = [
        ("decode_batch (device, batch resident)",
         lambda: xh.decode_batch(*batch, UNIT)),
        ("decode_batch fast_resolve (resolved archive, resident)",
         lambda: xh.decode_batch(*res_batch, UNIT, fast_resolve=True)),
        ("decompress_batch (host pack + copies + device)",
         lambda: tpucomp_torch.decompress_batch("xpress_huff", streams, lens,
                                                device="cuda")),
    ]
    for label, fn in timed:
        ms = cuda_ms(fn, reps=5)
        med = statistics.median(ms)
        print(f"xh {label}: median {med:.4f} ms of "
              f"{[round(m, 4) for m in ms]} -> {total / med / 1e6:.4f} GB/s")
    del res_batch
    steps: dict[str, list[float]] = {}
    for _ in range(3):
        b = clock(steps, "pack_units (host batch, copy to device)",
                  lambda: xh.pack_units(streams, lens, UNIT, dev))
        o, e = clock(steps, "decode_batch", lambda: xh.decode_batch(*b, UNIT))
        clock(steps, "err check", lambda: bool(e.any()))
        clock(steps, "copy to host + split", lambda: [
            r[:n].tobytes() for r, n in zip(o.cpu().numpy(), lens)])
    print("xh decompress_batch steps, host clock, median of 3 (ms): "
          + "; ".join(f"{k} {statistics.median(v):.4f}"
                      for k, v in steps.items()))
    # the resident decode, stage by stage (each synchronised)
    stages: dict[str, list[float]] = {}
    for _ in range(3):
        t = {}
        for name, fn in (
                ("tables", lambda: t.update(a=xh.parse_inputs(*batch))),
                ("xh_parse", lambda: t.update(p=xh_parse.xh_parse(*t["a"],
                                                                  UNIT))),
                ("fill_records", lambda: t.update(f=fill.fill_records_delta2(
                    t["p"][0], t["p"][1], UNIT, UNIT))),
                ("near_inputs (fold)", lambda: t.update(
                    n=xh.near_inputs(t["f"][0], t["f"][1]))),
                ("resolve_near", lambda: t.update(
                    r=resolve.resolve_near(*t["n"]))),
                ("far_level", lambda: t.update(s=gather.far_level(
                    t["r"], SEG_LEVEL, SEG_LEVEL_CAP, False))),
                ("far_row", lambda: t.update(w=gather.far_row(t["s"])))):
            stages.setdefault(name, []).extend(cuda_ms(fn, reps=1, warmup=0))
        del t
    print("xh decode_batch stages, CUDA events, median of 3 (ms): "
          + "; ".join(f"{k} {statistics.median(v):.4f}"
                      for k, v in stages.items()))
    profile_device("xh decompress_batch", lambda: tpucomp_torch.decompress_batch(
        "xpress_huff", streams, lens, device="cuda"))
    return launches


def main() -> None:
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    import tpucomp_torch
    from benchmarks.corpus import silesia_like
    from tpucomp_torch.codecs import lznt1 as lz
    from tpucomp_torch.kernels import _build, common, gather, lznt1_parse, resolve

    # ---- 1. device ----------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {kind} ({torch.cuda.device_count()} visible); "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    dev = torch.device("cuda", 0)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s, nvcc "
          f"{_build.find_nvcc()} -> {os.path.relpath(lib_path, ROOT)}")
    for line in log.splitlines():
        print(f"  nvcc: {line}")

    # ---- corpus (used by phases 3 and 4) ---------------------------------
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    data = (silesia_like(CORPUS_BYTES)
            + rng.integers(0, 256, RANDOM_TAIL, dtype=np.uint8).tobytes())
    print(f"corpus: {len(data)} bytes, sha256 "
          f"{hashlib.sha256(data).hexdigest()}, "
          f"{time.perf_counter() - t0:.2f} s to build")
    native = Native()
    stream = native.lznt1_compress(data)
    payloads, comps = lz.split_stream(stream)
    print(f"stream: {len(stream)} bytes (ratio {len(stream) / len(data)}), "
          f"{len(payloads)} chunks, {comps.count(False)} stored raw")

    # ---- 3. kernel vs plain -----------------------------------------------
    payload, plen, is_comp = lz.pack_chunks(payloads, comps, dev)
    N = payload.shape[0]
    bad = malformed_rows(payload, plen, is_comp, rng)
    parse_in = (payload, plen, is_comp)
    parsed = lznt1_parse.lznt1_parse(*parse_in)
    parsed_ref = lznt1_parse.lznt1_parse_ref(*parse_in)
    vpack = common.fill_records_delta(parsed[0], parsed[1], lz.CHUNK)
    is_copy = (vpack & lznt1_parse.COPY_BIT) != 0
    near_in = (is_copy, vpack & (lznt1_parse.COPY_BIT - 1),
               torch.where(is_copy, 0, vpack & 0xFF))
    near = resolve.resolve_near(*near_in)
    near_ref = resolve.resolve_near_ref(*near_in)
    far = gather.far_level(near)
    far_ref = gather.far_level_ref(near)
    torch.cuda.synchronize()
    err = parsed[3] != 0
    require(not bool(err[torch.from_numpy(np.setdiff1d(
        np.arange(len(payloads)), bad.numpy())).to(dev)].any()),
        "a well-formed chunk parsed with err set")
    print(f"kernel vs plain at N={N}: {int(err.sum())} rows with err "
          f"({N_MALFORMED} malformed rows injected), "
          f"{int(((near & common.FAR_TAG) != 0).sum())} far tags")

    kernels = []
    cases = [
        ("lznt1_parse", lznt1_parse.lznt1_parse, lznt1_parse.lznt1_parse_ref,
         parse_in, parsed, parsed_ref, "tpucomp/kernels/lznt1_pallas.py:153"),
        ("resolve_near", resolve.resolve_near, resolve.resolve_near_ref,
         near_in, (near,), (near_ref,),
         "tpucomp/kernels/resolve_pallas.py:123"),
        ("far_level", gather.far_level, gather.far_level_ref, (near,),
         (far,), (far_ref,), "tpucomp/kernels/gather_pallas.py:274"),
    ]
    for name, fn, ref, args, got, want, replaces in cases:
        max_err = compare(name, got, want)
        ms = statistics.median(cuda_ms(lambda: fn(*args), reps=20))
        plain_ms = statistics.median(cuda_ms(lambda: ref(*args), reps=3))
        print(f"{name}: equal to plain; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpucomp_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms})
    fill_ms = statistics.median(cuda_ms(
        lambda: common.fill_records_delta(parsed[0], parsed[1], lz.CHUNK),
        reps=5))
    print(f"fill_records_delta (plain torch, no kernel): {fill_ms:.4f} ms")
    del parsed, parsed_ref, vpack, is_copy, near_in, near, near_ref, far, far_ref

    # ---- 4. main path ----------------------------------------------------
    units = [data[i:i + UNIT] for i in range(0, CORPUS_BYTES, UNIT)]
    unit_streams = [native.lznt1_compress(u) for u in units]
    corrupt = (0xB000 | 2).to_bytes(2, "little") + bytes([1, 0, 0])
    for fn in (lznt1_parse.lznt1_parse, resolve.resolve_near,
               gather.far_level):
        fn.launches = 0
    out = tpucomp_torch.decompress("lznt1", stream, device="cuda")
    out_units = tpucomp_torch.decompress_batch("lznt1", unit_streams,
                                               device="cuda")
    try:
        tpucomp_torch.decompress("lznt1", corrupt, device="cuda")
        raised = False
    except tpucomp_torch.DataError:
        raised = True
    launches = {fn.__name__: fn.launches for fn in (
        lznt1_parse.lznt1_parse, resolve.resolve_near, gather.far_level)}
    print(f"main path launches: {launches}")
    require(out == data, "decompress output differs from the input")
    spans = chunk_spans(stream)
    for k in sorted(rng.choice(len(spans), 64, replace=False).tolist()):
        a, b = spans[k]
        want = native.lznt1_decompress(stream[a:b], lz.CHUNK)
        require(out[k * lz.CHUNK: k * lz.CHUNK + len(want)] == want,
                f"chunk {k} differs from the native C decoder")
    print(f"decompress: {len(out)} bytes equal to the input; 64 sampled "
          "chunks equal to the native C decoder")
    require(out_units == units, "decompress_batch output differs")
    print(f"decompress_batch: {len(units)} units of {UNIT} bytes equal")
    require(raised, "a corrupt stream (disp > pos) did not raise DataError")
    print("corrupt stream: DataError raised")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        require(k["launches"] > 0, f"{k['name']} never launched on the "
                "main path")

    batch = lz.pack_chunks(payloads, comps, dev)
    dec_ms = cuda_ms(lambda: lz.decode_batch(*batch), reps=5)
    e2e_ms = cuda_ms(
        lambda: tpucomp_torch.decompress("lznt1", stream, device="cuda"),
        reps=5)
    units_ms = cuda_ms(
        lambda: tpucomp_torch.decompress_batch("lznt1", unit_streams,
                                               device="cuda"), reps=5)
    for label, ms in (("decode_batch (device, batch resident)", dec_ms),
                      ("decompress (host split + copies + device)", e2e_ms),
                      ("decompress_batch (512 x 64 KiB units)", units_ms)):
        med = statistics.median(ms)
        print(f"{label}: median {med:.4f} ms of {[round(m, 4) for m in ms]}"
              f" -> {len(data) / med / 1e6:.4f} GB/s")
    # where decompress's time goes: host clock, each step synchronised
    steps: dict[str, list[float]] = {}
    for _ in range(3):
        pls, cps = clock(steps, "split_stream",
                         lambda: lz.split_stream(stream))
        b = clock(steps, "pack_chunks (host batch, copy to device)",
                  lambda: lz.pack_chunks(pls, cps, dev))
        o, ol, e = clock(steps, "decode_batch", lambda: lz.decode_batch(*b))
        clock(steps, "err check + joined_output (copy to host)",
              lambda: (bool(e.any()), lz.joined_output(o, ol)))
    print("decompress steps, host clock, median of 3 (ms): " + "; ".join(
        f"{k} {statistics.median(v):.4f}" for k, v in steps.items()))
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    profile_device(
        "decompress", lambda: tpucomp_torch.decompress("lznt1", stream,
                                                       device="cuda"))
    del batch

    # ---- 5-6. Xpress Huffman ------------------------------------------------
    xh_launches = xh_phases(dev, units, native, kernels)
    for k in kernels:
        k["launches"] = k.get("launches", 0) + xh_launches.get(k["name"], 0)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

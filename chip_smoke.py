#!/usr/bin/env python3
"""Smoke run of tpucomp_torch on one NVIDIA GPU: LZNT1 decode end to end.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit code:

1. Device: the card's name and power limit.
2. Build: nvcc builds the port's CUDA kernels from ``tpucomp_torch/
   kernels/csrc``.
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   same CUDA tensors at the main path's shape (one row per chunk of the
   corpus, 256 rows replaced by seeded malformed ones), equal exactly;
   then each one's time, CUDA-event timed after a warm-up.
4. Main path: the 32 MiB corpus of benchmarks/corpus.py plus 64 KiB of
   seeded random bytes (so that chunks are stored raw) is encoded by the
   repo's native C encoder, decoded by ``tpucomp_torch.decompress`` and
   compared with the input, 64 sampled chunks also against the native C
   decoder; 512 units of 64 KiB go through ``decompress_batch``; a corrupt
   stream must raise ``DataError``.  Every kernel must have launched on
   this path.  Then decode GB/s, the median of 5 runs after a warm-up;
   ``decompress`` step by step; and one ``decompress`` under
   ``torch.profiler``: the device's busy time and idle share, and the
   device ops that take the most time.

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


def native_codec():
    """The repo's native C LZNT1 codec (tpucomp/native), built with the
    host C compiler into the port's build directory and bound by ctypes."""
    from tpucomp_torch.kernels import _build

    src = os.path.join(ROOT, "tpucomp", "native", "tpucomp_native.c")
    cc = shutil.which("cc") or shutil.which("gcc")
    require(cc is not None, "no C compiler (cc or gcc) on PATH")
    lib_path, _ = _build.shared_library(cc, ["-O3", "-fPIC", "-shared"],
                                        [src], "tpucomp_native")
    lib = ctypes.CDLL(lib_path)
    for fn in (lib.lznt1_compress, lib.lznt1_decompress):
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                       ctypes.c_int]
        fn.restype = ctypes.c_int

    def call(fn, data: bytes, cap: int) -> bytes:
        out = ctypes.create_string_buffer(cap)
        n = fn(data, len(data), out, cap)
        require(n >= 0, f"native codec returned {n}")
        return out.raw[:n]

    def compress(data: bytes) -> bytes:
        bound = len(data) + 2 * (len(data) // 4096 + 2) + 16
        return call(lib.lznt1_compress, data, bound)

    def decompress(data: bytes, out_len: int) -> bytes:
        return call(lib.lznt1_decompress, data, out_len)

    return compress, decompress


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
    native_compress, native_decompress = native_codec()
    stream = native_compress(data)
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
        max_err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                      for g, w in zip(got, want))
        require(max_err == 0, f"{name} differs from its plain version "
                f"(max abs err {max_err})")
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
    unit_streams = [native_compress(u) for u in units]
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
        want = native_decompress(stream[a:b], lz.CHUNK)
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

    def clock(name, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        steps.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return res

    for _ in range(3):
        pls, cps = clock("split_stream", lambda: lz.split_stream(stream))
        b = clock("pack_chunks (host batch, copy to device)",
                  lambda: lz.pack_chunks(pls, cps, dev))
        o, ol, e = clock("decode_batch", lambda: lz.decode_batch(*b))
        clock("err check + joined_output (copy to host)",
              lambda: (bool(e.any()), lz.joined_output(o, ol)))
    print("decompress steps, host clock, median of 3 (ms): " + "; ".join(
        f"{k} {statistics.median(v):.4f}" for k, v in steps.items()))
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    profile_device(
        "decompress", lambda: tpucomp_torch.decompress("lznt1", stream,
                                                       device="cuda"))

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

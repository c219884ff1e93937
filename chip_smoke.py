#!/usr/bin/env python3
"""Smoke run of tpucomp_torch on one NVIDIA GPU: LZNT1 decode, Xpress
Huffman (XH) batched decode, LZNT1 encode, plain Xpress unit decode and
encode, XH encode, the one-shot XH decode, plain Xpress's single-stream
encode, the dist layer and the streaming API end to end, then the
decoders on mutated streams.

    python3 chip_smoke.py

(``python3 chip_smoke.py --dist-worker RANK PORT PATH`` is one rank of
phase 16's two-rank group; phase 16 starts both.)

Phases, in order; any failure ends the run with a nonzero exit code:

1. Device: the card's name and power limit.
2. Build: nvcc builds the port's CUDA kernels from ``tpucomp_torch/
   kernels/csrc``, one process per source, all at once.
3. LZNT1 kernel vs plain: each kernel against its plain PyTorch version on the
   same CUDA tensors at the main path's shape (one row per chunk of the
   corpus, 256 rows replaced by seeded malformed ones), equal exactly;
   then each one's time, CUDA-event timed after a warm-up, and its bound;
   the parse's windows per row, and its time in runs of ``BURST`` calls
   back to back beside ``fill_`` of its two record planes (the same
   bytes written).  The record fill in its value-only form (LZNT1's [N,
   4616] records to [N, 4096]) likewise, in runs of ``BURST`` beside
   ``clone()`` of the record planes plus ``fill_`` of the output plane
   (the records moved twice, the plane once).
4. LZNT1 main path: the 32 MiB corpus of benchmarks/corpus.py plus 64 KiB of
   seeded random bytes (so that chunks are stored raw) is encoded by the
   repo's native C encoder, decoded by ``tpucomp_torch.decompress`` and
   compared with the input, 64 sampled chunks also against the native C
   decoder; 512 units of 64 KiB go through ``decompress_batch``; a corrupt
   stream must raise ``DataError``.  Every kernel must have launched on
   this path, the fill included.  Then decode GB/s, the median of 5 runs
   after a warm-up; ``decompress`` step by step; and one ``decompress`` under
   ``torch.profiler``: the device's busy time and idle share, and the
   device ops that take the most time.
5. XH kernel vs plain: the corpus's 512 units of 64 KiB, one of seeded
   random bytes and one of zeros, each encoded by the native C XH
   encoder, plus 32 seeded malformed units, in one batch of 546 rows.
   Every XH kernel against its plain version on the same CUDA tensors,
   equal exactly, both times and the bound (the near walk's too, at this
   shape); the fill also in runs of ``BURST`` beside that yardstick,
   and on the zeros unit's row alone and on 546 rows of
   literals.  The parse's plain version loops once
   per body byte, so it runs on a sub-batch of short rows (the shortest
   corpus streams and the malformed rows), and the kernel with it.  The
   parse's rounds per row (corpus rows and tier-3 rows apart), and its
   time on the whole batch, the sub-batch and the random unit alone.  How
   many rows the full-row level swept and how many ran its round loop
   (the units' rows and the malformed rows apart; no unit's row may).
   The probes also in runs of ``BURST`` beside ``clone()`` of their plane,
   with the host's time to issue a call, and on 546 rows that each hold
   one chain of 61440 tags at 1, 2 and 5 rounds.
6. XH main path, with every launch count set to 0 first:
   ``decompress_batch("xpress_huff", ...)`` of the 514 units, equal to
   them (16 sampled units also to the native C decoder); the same units
   encoded as resolved archives (depth 2) through ``decompress_units(...,
   fast_resolve=True)``; a corrupt unit must raise ``DataError``; every XH
   kernel must have launched.  Then GB/s of ``decode_batch`` (resident)
   and ``decompress_batch``, the median of 5; the host steps; the device
   stages, of the native and of the resolved streams (with the probes);
   peak memory; and one ``decompress_batch`` under the profiler.

7. Encode kernel vs plain: the corpus's 8208 chunks as one [8208, 4096]
   batch on the card.  The run matcher, the row sort (the hash sort's key
   plane and the un-sort's two planes, each beside ``torch.sort`` (+
   ``gather``), the library call, with the digit passes its rows ran),
   and the greedy walk with and without the layout sums (with the rounds
   its rows took), each against its plain version on the same tensors,
   equal exactly; each one's time, its plain version's and its bound.
   The run matcher also in runs of ``BURST`` beside ``x.clone()`` and
   ``fill_`` of its output planes, with the host's time to issue a call
   (so too in phases 9 and 11).
8. Encode main path, with the encode kernels' launch counts set to 0
   first: ``tpucomp_torch.compress("lznt1", data)`` of the corpus, equal
   to ``compress(..., device="cpu")`` (the plain versions end to end) and
   decoding back through ``decompress`` on the card and the native C
   decoder; ``compress_batch`` of its 4 KiB units plus odd-length ones,
   equal to the one-shot's chunks and decoding back; every encode kernel
   must have launched in both calls.  Then the compressed size beside the
   native C encoder's; GB/s of ``encode_batch`` (resident), ``compress``
   and ``compress_batch``, the median of 5; ``compress`` step by step;
   ``find_matches`` stage by stage; peak memory; one ``compress`` under
   the profiler.
9. Xpress kernel vs plain: the corpus's 512 units of 64 KiB, one of
   seeded random bytes and one of zeros, each encoded by the native C
   Xpress encoder, plus 32 seeded malformed rows, in one batch.  The
   parse against its plain version on a sub-batch of short rows (the
   shortest corpus streams and the malformed rows: the plain version
   loops once per payload byte); the parse's skeleton steps per row
   (corpus rows and the random unit apart), the occupancy it reached, and
   its time on the whole batch, the sub-batch, the random unit alone and
   514 units of seeded random bytes (decoding back); on the whole batch
   the decode tail's
   kernels (fill, near walk, 4 KiB level, row level, with the row
   level's branches as in phase 5; the fill as in phase 5, and on the
   zeros unit's row alone); then the encode
   kernels at [514, 65536]: the run matcher (also on 514 all-zero rows,
   the zeros unit's row alone and 514 rows of random bytes), the row sort
   of the hash key and of the un-sort (beside ``torch.sort`` + ``gather``)
   and the greedy walk (with its rounds, and its time on rows with no
   chain and on all literals), each against its plain version, with
   their times.
10. Xpress main path, with every launch count set to 0 first:
   ``decompress_batch("xpress", ...)`` of the 514 streams, equal to the
   units (16 sampled also to the native C decoder);
   ``compress_batch("xpress", ...)`` of the units, equal to
   ``compress_batch(..., device="cpu")`` (the plain versions on the
   host) and decoding back through the port and the native C decoder; a
   one-shot ``compress`` / ``decompress`` round trip of 50,000 bytes; a
   corrupt unit must raise ``DataError``; every kernel of the slice must
   have launched.  Then the ratio beside the native C encoder's; GB/s of
   ``decode_batch`` and ``encode_batch`` (resident), ``decompress_batch``
   and ``compress_batch``, the median of 5; the stages; peak memory; one
   ``decompress_batch`` and one ``compress_batch`` under the profiler.
11. XH encode kernel vs plain: the 514 units of phase 5 as one [514,
   65536] batch.  The row gather at the lookup's shape (a 512-entry table,
   65536 queries a row) and at the TPU kernel's own K = 65536, beside
   ``torch.gather``; the run matcher, the row sort of the hash key and of
   the un-sort (no window bound, each beside ``torch.sort`` (+
   ``gather``), with its digit passes) and the greedy walk on the XH
   rows (with its rounds).  Each against its plain version, equal exactly, with both times.
12. XH encode main path, with every launch count set to 0 first:
   ``compress_batch("xpress_huff", ...)`` of the 514 units and a one-shot
   ``compress`` of 200 KiB (four blocks); a sub-batch of 32 units (the
   random one, the zeros, a short one and 29 from the corpus) encoded on
   the card equal to ``compress_batch(..., device="cpu")`` and to the big
   batch's rows; all 514 streams decoding back through the port's
   ``decompress_batch`` on the card, 16 sampled ones and the one-shot
   also through the native C decoder; every kernel of the path launched.
   Then the ratio beside the native C encoder's; GB/s of ``encode_batch``
   (resident) and ``compress_batch``, the median of 5; the stages; peak
   memory; one ``compress_batch`` under the profiler.
13. XH one-shot kernels vs plain: the speculative batch of the corpus's
   first 8 MiB by the native C XH encoder (every Kraft candidate a full
   block over an all-zero history: [N, 131072] rows of [history |
   block]).  The parse with hist_len and the span against its plain
   version on the 8 rows without err whose spans are the shortest and on
   the fixpoint batch of ``XH_VECTOR`` (each block over the true output
   before it), the near walk, the 4 KiB level and the row level on the
   whole batch, each equal exactly, with both times and the bound; the
   parse's rounds; the row level's branches (no row without err may run
   its round loop).
14. XH one-shot main path, with every launch count set to 0 first:
   ``decompress("xpress_huff", ...)`` of the 8 MiB stream (the
   speculative path; also equal to the native C decoder's), of the first
   10 x 65536 - 1234 bytes (a partial last block), of the whole corpus
   (513 blocks: more Kraft candidates than 512, so the sequential walk)
   and of ``XH_VECTOR`` (matches across blocks: fixpoint passes), each
   equal to its input; a stream cut short must raise ``DataError``; the
   parse, fill, near walk and both far levels must have launched.  Then
   GB/s of each call, the median of 5 (the whole corpus: 1 run), its
   batch decodes and host steps; peak memory; one call under the
   profiler.
15. Xpress stream encode (``compress("xpress", data)`` over 64 KiB: one
   stream, lanes of [8 KiB history | 64 KiB] rows of 73,728): on the
   corpus's first dispatch (128 lanes), the run matcher on its rows, the
   row sort of its hash keys and of the un-sort (beside ``torch.sort``
   (+ ``gather``)) and the greedy walk on its [128, 65536] walk inputs,
   each against its plain version, equal exactly, with both times and the
   bound.  Then, with every launch count set to 0 first, the committed
   vector ``XP_STREAM_VECTOR`` (the card's bytes equal to it by sha256)
   and the corpus (513 lanes, 5 dispatches), decoding back through the
   native C decoder and equal to its run in dispatches of 8 lanes; every
   kernel of the path must have launched.  Then the size beside the
   native C one-shot encoder's and beside ``compress_batch`` of the 64
   KiB units; GB/s, the median of 5 after a warm-up; the host clock of
   each step of a dispatch, summed over the dispatches; peak memory; one
   call under the profiler.

16. The dist layer.  First what it is held to: ``compress_batch`` of
   the corpus's units in each format, the native C build's resolved
   streams (each unit from a depth state zeroed by
   :func:`literal_block`), ``ShardedCodec`` of each ``MixedBatch`` job
   and ``compress`` of the corpus.  Then, with every launch count set to
   0 and only the sharded path run until the counts are read: with no
   process group (one rank), ``ShardedCodec`` of the corpus in each
   format (LZNT1's 8208 units of 4 KiB, Xpress's and XH's 513 of 64 KiB):
   the archive's unit streams equal to ``compress_batch``'s,
   ``to_bytes`` / ``from_bytes`` round-tripping, ``decompress`` equal to
   the corpus (LZNT1's payload also as one stream through the native C
   decoder), resumed at half equal to the one-call archive; resolved
   Xpress and XH archives (depth 2) by the port's copy of the native
   encoder, equal to the native C build's streams, decoding back with
   ``fast_resolve`` (``far_probe`` must launch); ``MixedBatch`` of five
   interleaved jobs and ``ShardedLZNT1`` of the corpus; all twelve kernels
   must have launched.  Then the first 8 MiB through a one-rank NCCL
   group in this process (the all-gather on the card) and through two
   worker processes in a gloo group, both on cuda:0, their archives equal
   to the one-rank ones by sha256, with their times; GB/s of
   ``ShardedCodec.compress`` / ``decompress`` beside ``compress_batch`` /
   ``decompress_batch`` of the same units, the median of 5 after a
   warm-up, in turns, and each call split on the host clock
   (:func:`dist_split`).  Before phase 3 and at the end of phase 16, one
   LZNT1 ``decompress`` of 8 MiB with ``trace_dir``, whose trace must
   name the LZNT1 decode kernels, each launch with its device record.
17. The streaming API.  With every launch count set to 0 first (the
   one-shot encode it is held to made before): the corpus's first 8 MiB
   through ``Compressor("lznt1")`` on the card in seeded log-uniform
   feeds of 1 B to 256 KiB, equal to one-shot ``compress`` on the card
   and decoding back through the native C decoder; that stream through
   ``Decompressor("lznt1")`` in such feeds, equal to the input;
   ``decompress_unit`` of 16 corpus units of 64 KiB in plain Xpress and
   XH (native C streams), equal to them; the LZNT1 kernels and the
   unit decodes' parses, fill, near walk and both far levels must have
   launched.  Then each direction fed beside its one-shot call on the
   same bytes, the median of 3 in turns after a warm-up, and the cost of
   feeding a device call; one fed decode under the profiler.  Then
   ``backend="cpu"``: the port's native one-shot calls of the 8 MiB in
   the three formats equal to the reference build's (``Native``), its
   ``Compressor`` streams in ragged feeds equal to them (plain Xpress
   may differ only across a match deferred past 1 MiB, printed) and its
   ``Decompressor`` decoding back, with their host times; and
   ``backend="oracle"``: 64 KiB of each format through the classes,
   equal to the oracle's one-shot (XH with ``cross_block=True``) and
   decoding back.
18. The decoders on mutated streams.  Seeded mutants of the operators of
   ``tests/_mutate.py`` (loaded by path; numpy only): each of the
   corpus's LZNT1 chunks mutated once a batch, in two batches of about
   [8208, 4616]; 19 batches of 546 mutants of the 64 KiB units' plain
   Xpress and XH streams at [546, 65536] (of the XH batches, three of
   resolved streams with ``fast_resolve``, so that the probes run); 64
   mutants at the block tables of the 10-block XH stream of phase 14
   through ``decompress``.  With every launch count set to 0 first, each
   batch is one ``decode_batch`` on the card, and every mutant's
   accept/reject and bytes are held to the port's native C decoder; each
   disagreement must be one of the classes of ``_mutate.CLASSES``
   (``_mutate.classify``), which the CPU tests
   (``tests/test_torch_fuzz_*.py``) list.  The phase prints the mutants,
   each side's rejects, the classes and its time.  Then each decode
   kernel against its plain version on the same CUDA tensors, exactly:
   both LZNT1 batches whole; the Xpress and XH parses on the rows of
   the shortest streams (at most 32, of at most 4096 bytes) of a batch,
   alone and as rows of the whole batch's launch; the fill, the near
   walk, both far levels and the probes on whole batches.

Phases 3, 9 and 13 also time ``far_level`` in runs of ``BURST`` calls
back to back beside ``clone()`` of its plane (its ``shapes``).
Every profiler pass (:func:`profile_device`) opens its session with
``stats.device_trace``'s primer of small kernels, left out of the busy
time and the top ops, and warns when a launch of the call has no device
record.

The last two lines are JSON: the kernels (the entries of the fill, the
run matcher and the probes also list each shape and input under
``shapes``, with its back-to-back, host and yardstick times; ``fuzz``
is each kernel's launches in phase 18, also counted in ``launches``),
and
``{"ok": true, "device":
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
N_XP_MALFORMED = 32
XP_SUB_SHORTEST = 32
XHE_SUB_CORPUS = 29  # corpus units in the XH encode host sub-batch
ONESHOT_BYTES = 200 << 10
BURST = 10  # calls a run, timed back to back
# the one-shot XH decode's cross-block stream: the oracle's encoding
# (cross_block=True) of benchmarks.corpus._synthetic(3 * 65536), whose
# sha256 this is (tests/test_torch_xh_oneshot.py regenerates both)
XH_VECTOR = os.path.join("tests", "data", "xh_cross_block.bin")
XH_VECTOR_INPUT_SHA256 = \
    "d20845339a4c664554b3c4a8e437c4d10b31aa82287abba7dec701e948e955c6"
XH_SPEC_BYTES = 8 << 20  # the corpus prefix of the speculative path
# plain Xpress's single stream over 64 KiB: tpucomp's compress_stream of
# benchmarks.corpus._synthetic(3 * 65536 + 4321) (four lanes, the last
# partial); tests/test_torch_xpress_stream_wide.py regenerates it
XP_STREAM_VECTOR = os.path.join("tests", "data", "xp_stream.bin")
XP_STREAM_INPUT_SHA256 = \
    "3133b93a5f59fcfc8c0bd37daab50ba399f621a94e2147fedf778f4034a0a6a4"
XP_STREAM_SHA256 = \
    "5c8b7b0c543ae009f292449b4e4af63dd2f6fdf5b0f5db9d6083544a4bd52b78"
XH_TEN_BLOCKS = 10 * UNIT - 1234  # tpucomp's test shape: a partial block


# H100 SXM device memory rate (NVIDIA's data sheet): every kernel here is
# bound by bytes, so its bound is the bytes it must move over this rate
HBM_BYTES_PER_S = 3.35e12


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_entry(name, replaces, max_err, ms, plain_ms, moved,
                 library_ms=None) -> dict:
    """The ``kernels`` line's entry of one kernel: ``moved`` is the bytes
    its inputs and outputs hold at this run's shapes (each read or
    written once), over the device memory rate."""
    return {"name": name, "route": "cuda",
            "source": f"tpucomp_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": library_ms}


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


def burst_ms(fn, reps: int) -> list[float]:
    """Per-call device times in ms of ``BURST`` calls back to back, one
    CUDA-event pair around each run of them: the card's own time, the
    host's launch work hidden behind the calls before it."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BURST):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / BURST)
    return times


def host_ms(fn, reps: int) -> list[float]:
    """The host's time in ms to issue ``fn`` (its checks, allocations and
    launches) on an idle card, not waiting for the card: while the host
    works the card waits, so a call's time exceeds its back-to-back time
    by about as much."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return times


def time_in_turns(fns: dict, turns: int = 3, reps: int = 5) -> None:
    """Time each function of ``fns`` (label -> function) a call (CUDA
    events), in runs of ``BURST`` calls back to back and by the host's
    time to issue a call, all of them in turn, ``turns`` times over; print
    the median of the turns' medians, with the turns."""
    hows = {"a call": cuda_ms, f"in runs of {BURST}": burst_ms,
            "host, a call": host_ms}
    got = {(name, how): [] for name in fns for how in hows}
    for _ in range(turns):
        for name, fn in fns.items():
            for how, timer in hows.items():
                got[name, how].append(statistics.median(timer(fn, reps=reps)))
    for (name, how), ms in got.items():
        print(f"  {name}, {how}: {statistics.median(ms):.4f} ms (turns "
              f"{', '.join(f'{t:.4f}' for t in ms)})")


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
    compiler into the port's build directory and bound by ctypes: LZNT1,
    plain Xpress and Xpress Huffman encode and decode."""

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
                   lib.xpress_compress, lib.xpress_decompress,
                   lib.xh_compress, lib.xh_decompress):
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                           ctypes.c_int]
            fn.restype = ctypes.c_int
        for fn in (lib.xh_compress_opt, lib.xpress_compress_opt):
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                           ctypes.c_int, ctypes.c_int]
            fn.restype = ctypes.c_int

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

    def xpress_compress(self, data: bytes) -> bytes:
        bound = len(data) + 4 * ((len(data) + 31) // 32) + 16
        return self._call(self.lib.xpress_compress, data, bound)

    def xpress_compress_opt(self, data: bytes, flags: int) -> bytes:
        bound = len(data) + 4 * (len(data) // 32 + 2) + 16
        return self._call(self.lib.xpress_compress_opt, data, bound, flags)

    def xpress_decompress(self, data: bytes, out_len: int) -> bytes:
        return self._call(self.lib.xpress_decompress, data, out_len)

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
    wall, and the device ops with the most device time.

    The session opens as ``stats.device_trace``'s does: ``PRIMER_LAUNCHES``
    small kernels under the ``PRIMER`` annotation first (a session in a
    process that has run for minutes loses its first device records),
    left out of the busy time and the top ops; a warning names the
    call's kernel launches that still have no device record
    (``stats.lost_launches``)."""
    import tempfile
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpucomp_torch import stats

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(stats.PRIMER):
            x = torch.zeros(1, device="cuda")
            for _ in range(stats.PRIMER_LAUNCHES):
                x.add_(1)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    primer_end = max(e.time_range.end for e in events
                     if e.name == stats.PRIMER)
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.time_range.start >= primer_end]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
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
          f"{(spans[-1][1] - spans[0][0]) / 1e3:.4f} ms (after the "
          f"primer's {stats.PRIMER_LAUNCHES} launches)")
    by_name: dict = {}
    for e in device:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.end - e.time_range.start, n + 1)
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:8]:
        print(f"  device {us / 1e3:.4f} ms in {n} calls: {name}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            lost = stats.lost_launches(json.load(f)["traceEvents"])
    if lost:
        msg = (f"profile_device: {label}: {len(lost)} kernel launches have "
               "no device record (the profiler dropped them); the busy "
               "time above misses them")
        print(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)


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


def hold_to_plain(where, label, fn, ref, args, reps=10, plain_reps=3,
                  extra="", need=None):
    """Hold kernel wrapper ``fn`` to its plain version ``ref`` on ``args``
    (equal exactly), then time both with CUDA events (medians) and print
    them beside the bound: the tensors of ``args`` read once, the outputs
    written once, or ``need(outputs)`` bytes where the function needs
    only part of its inputs.  Returns (output, max abs err, kernel ms,
    plain ms, bytes moved)."""
    import torch

    got = fn(*args)
    max_err = compare(label, got, ref(*args))
    ms = statistics.median(cuda_ms(lambda: fn(*args), reps=reps))
    plain_ms = statistics.median(cuda_ms(lambda: ref(*args), reps=plain_reps))
    ins = [t for a in args for t in (a if isinstance(a, tuple) else (a,))
           if isinstance(t, torch.Tensor)]
    outs = (got,) if isinstance(got, torch.Tensor) else tuple(got)
    moved = nbytes(*ins, *outs) if need is None else need(outs)
    print(f"{label} ({where} shapes {[list(t.shape) for t in ins]}): equal to "
          f"plain; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms{extra}")
    return got, max_err, ms, plain_ms, moved


def fold_err(kernels, label, max_err) -> None:
    """Fold a comparison into the existing entry of the kernel that
    ``label`` names (its first word)."""
    k = next(k for k in kernels if k["name"] == label.split(" ")[0])
    k["max_abs_err"] = max(k["max_abs_err"], max_err)


def fill_bytes(rec_pos, U, outs) -> int:
    """The bytes the record fill must move on this run's data: rec_pos
    read whole (each slot says whether its record is real), rec_val only
    in the 32-byte sectors of a row that hold a real record, and the
    output planes ``outs`` written once."""
    import torch

    N, R = rec_pos.shape
    real = (rec_pos >= 0) & (rec_pos < U)
    if R % 8:
        real = torch.cat([real, real.new_zeros(N, -R % 8)], dim=1)
    sectors = int(real.reshape(N, -1, 8).any(dim=2).sum())
    return nbytes(rec_pos, *outs) + 32 * sectors


def burst_case(kernels, name, where, fn, ref, args, yard, yard_label,
               replaces=None, reps=20, plain_reps=3, need=None, extra=None):
    """:func:`hold_to_plain` of kernel wrapper ``fn`` on ``args``; then its
    time in runs of ``BURST`` calls back to back, the host's time to issue
    one call, and a yardstick ``yard`` that moves the same bytes, in runs
    of ``BURST`` too.  The shape joins the ``shapes`` of kernel ``name``'s
    entry in ``kernels`` (with ``extra``); the entry is made with this
    shape's times where ``replaces`` is given and it has none yet.
    Returns the kernel's output."""
    got, max_err, ms, plain_ms, moved = hold_to_plain(
        where, name, fn, ref, args, reps=reps, plain_reps=plain_reps,
        need=need)
    b2b = statistics.median(burst_ms(lambda: fn(*args), reps=5))
    host = statistics.median(host_ms(lambda: fn(*args), reps=5))
    yard_ms = statistics.median(burst_ms(yard, reps=5))
    print(f"{name} ({where}): {b2b:.4f} ms back to back ({BURST} calls a "
          f"run), the host {host:.4f} ms to issue a call; {yard_label} "
          f"{yard_ms:.4f} ms back to back")
    entry = next((k for k in kernels if k["name"] == name), None)
    if entry is None:
        require(replaces is not None, f"{name}: no entry to add {where} to")
        entry = kernel_entry(name, replaces, max_err, ms, plain_ms, moved)
        entry["shapes"] = []
        kernels.append(entry)
    entry["max_abs_err"] = max(entry["max_abs_err"], max_err)
    entry.setdefault("shapes", []).append({
        "where": where, **(extra or {}), "ms": ms, "back_to_back_ms": b2b,
        "host_ms": host, "yardstick_ms": yard_ms, "plain_ms": plain_ms,
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3})
    return got


def fill_case(kernels, where, fn, ref, args, plain_reps=3):
    """:func:`burst_case` of a form of the record fill
    (``fill_records_delta2``, or ``fill_records_delta``, the value plane
    alone) on ``args`` (rec_pos, rec_val, U[, keep]), its bound
    :func:`fill_bytes`, beside a yardstick that moves the records twice
    and the planes once (``clone()`` of the two record planes and
    ``fill_`` of the output planes).  Returns the kernel's output."""
    import torch

    recs = args[:2]
    N = recs[0].shape[0]
    # the outputs: the value plane, or the value and position planes and
    # the overflow flags
    two = fn.__name__ == "fill_records_delta2"
    planes = [recs[0].new_empty(shape) for shape in (
        [(N, args[2]), (N, args[2]), (N,)] if two else [(N, args[2])])]
    return burst_case(
        kernels, "fill_records", where, fn, ref, args,
        lambda: ([r.clone() for r in recs], [p.fill_(0) for p in planes]),
        "clone() of the record planes + fill_ of the output planes",
        replaces="tpucomp/kernels/fill_pallas.py:180",
        plain_reps=plain_reps,
        need=lambda outs: fill_bytes(recs[0], args[2], outs),
        extra={"records": list(recs[0].shape), "out": [N, args[2]],
               "planes": 1 + two})


def runs_case(kernels, where, x, disps):
    """:func:`burst_case` of the run matcher on ``x`` (uint8 [N, U]),
    beside ``x.clone()`` and ``fill_`` of its output planes."""
    import torch

    from tpucomp_torch.kernels import runs

    planes = torch.empty((len(disps), *x.shape), dtype=torch.int32,
                         device=x.device)
    burst_case(kernels, "run_matchlens", where, runs.run_matchlens,
               runs.run_matchlens_ref, (x, disps),
               lambda: (x.clone(), planes.fill_(0)),
               "x.clone() + fill_ of the output planes",
               replaces="tpucomp/kernels/runs_pallas.py:82",
               extra={"shape": list(x.shape), "disps": list(disps)})


def probe_case(kernels, where, states, rounds):
    """:func:`burst_case` of the archive probe on ``states`` (int32 [N,
    U]) with ``rounds``, beside ``states.clone()``."""
    from tpucomp_torch.kernels import gather

    return burst_case(kernels, "far_probe", where, gather.far_probe,
                      gather.far_probe_ref, (states, rounds),
                      lambda: states.clone(), "clone() of the plane",
                      replaces="tpucomp/kernels/gather_pallas.py:150",
                      reps=10, extra={"shape": list(states.shape),
                                      "rounds": rounds})


def far_level_case(kernels, where, args):
    """:func:`burst_case` of the 4 KiB far level on ``args`` (its input
    plane first), beside ``clone()`` of the plane.  Returns the level's
    output."""
    from tpucomp_torch.kernels import gather

    return burst_case(kernels, "far_level", where, gather.far_level,
                      gather.far_level_ref, args, lambda: args[0].clone(),
                      "clone() of the plane", reps=10,
                      extra={"shape": list(args[0].shape)})


def sort_case(where, label, planes, reps=10, plain_reps=3):
    """:func:`hold_to_plain` of the row sort on ``planes`` (the key
    first), timed beside ``torch.sort`` (+ ``gather`` of the payload
    planes), the library call computing the same function; then the digit
    passes its rows ran, on a line of their own.  Returns (max abs err,
    kernel ms, plain ms, bytes moved, library ms)."""
    import torch

    from tpucomp_torch.kernels import sort

    def library():
        s_key, idx = torch.sort(planes[0], dim=1)
        return (s_key, *(p.gather(1, idx) for p in planes[1:]))

    lib_ms = statistics.median(cuda_ms(library, reps=reps))
    lib = "torch.sort + gather" if len(planes) > 1 else "torch.sort"
    _, err, ms, plain_ms, moved = hold_to_plain(
        where, label, sort.sort_rows, sort.sort_rows_ref, (planes,), reps,
        plain_reps, extra=f", {lib} {lib_ms:.4f} ms")
    passes = sort.digit_passes(planes[0])
    print(f"{label} ({where}): digit passes per row {int(passes.min())} "
          f"to {int(passes.max())}, of up to 4")
    return err, ms, plain_ms, moved, lib_ms


def walk_rounds(where, fn, n) -> None:
    """Print the rounds the rows (of n positions) of the walk wrapper
    ``fn``'s last launch took (max and mean), beside the most they could
    take."""
    from tpucomp_torch.kernels import commit

    r = fn.rounds.float()
    print(f"{fn.__name__} ({where}): rounds per row max {int(r.max())}, "
          f"mean {float(r.mean()):.4f}, of at most "
          f"{commit.segments(n)} (the row's segments)")


def xh_parse_rounds(ss, n_corpus) -> None:
    """Print the rounds the rows of the XH parse's last launch took (max
    and mean): the corpus rows (``n_corpus`` first), the tier-3 rows
    (``ss`` 3: segments re-decoded) and the other rows apart."""
    import torch

    from tpucomp_torch.kernels import xh_parse

    r = xh_parse.xh_parse.rounds.float()
    corpus = torch.arange(len(r), device=r.device) < n_corpus
    tier3 = ss == 3
    parts = [("corpus rows", corpus & ~tier3),
             ("tier-3 rows (segments re-decoded)", tier3),
             ("other rows", ~corpus & ~tier3)]
    print("xh_parse rounds per row: " + "; ".join(
        f"{label} ({int(m.sum())}): max {int(r[m].max())}, mean "
        f"{float(r[m].mean()):.4f}" for label, m in parts if bool(m.any())))


def far_row_branches(where, n_units) -> None:
    """Print how many rows of far_row's last launch were swept and how
    many ran the round loop, the units' rows (``n_units`` first) and the
    malformed rows apart; fails if a unit's row ran the round loop (the
    states of a valid stream point backward)."""
    from tpucomp_torch.kernels import gather

    looped = gather.far_row.looped.bool().cpu()
    parts = [("units' rows", looped[:n_units]),
             ("malformed rows", looped[n_units:])]
    print(f"far_row branches ({where}): " + "; ".join(
        f"{label} ({len(m)}): swept {int((~m).sum())}, round loop "
        f"{int(m.sum())}" for label, m in parts))
    require(not bool(looped[:n_units].any()),
            f"a unit's row took far_row's round loop ({where})")


def xh_units(units, rng) -> list:
    """The corpus's units of 64 KiB, one of random bytes from ``rng``
    (substep tier 3, the longest XH body) and one of zeros (tier 17)."""
    return list(units) + [
        rng.integers(0, 256, UNIT, dtype=np.uint8).tobytes(), bytes(UNIT)]


def xh_phases(dev, units, native, kernels) -> dict:
    """Phases 5 and 6, Xpress Huffman.  Adds the XH kernels' entries to
    ``kernels`` (and the XH comparisons of resolve_near and far_level to
    theirs) and returns the launches of every kernel on the XH main path."""
    import torch

    import tpucomp_torch
    from tpucomp_torch.codecs import xpress_huff as xh
    from tpucomp_torch.kernels import fill, gather, resolve, xh_parse
    from tpucomp_torch.kernels.common import (ARCHIVE_PROBE_BUDGET, FAR_TAG,
                                              SEG_LEVEL, SEG_LEVEL_CAP)

    rng = np.random.default_rng(SEED + 1)
    units = xh_units(units, rng)
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
    xh_parse_rounds(batch[3], n_corpus)
    # the tier-3 random unit alone: the row that sets the whole batch's time
    one = tuple(a[n_corpus:n_corpus + 1] for a in args)
    parse_one_ms = statistics.median(cuda_ms(
        lambda: xh_parse.xh_parse(*one, UNIT), reps=5))
    print(f"xh_parse: the random unit alone ([1, {one[0].shape[1]}], body "
          f"{int(one[1][0])} bytes, substep tier {int(one[3][0])}) "
          f"{parse_one_ms:.4f} ms, {int(xh_parse.xh_parse.rounds[0])} "
          "segments re-decoded")
    # the body bytes as far as each row's length, the rest of the inputs
    # and the record planes whole (the whole batch here, the sub-batch in
    # the kernel's entry)
    whole = (int(args[1].clamp(min=0).sum()) + nbytes(*args[1:])
             + nbytes(*parsed))
    print(f"xh_parse: equal to plain on a sub-batch of {len(sub)} rows (the "
          f"{XH_SUB_SHORTEST} shortest corpus streams and the malformed "
          f"rows, longest body {sub_blen} bytes): kernel {parse_sub_ms:.4f} "
          f"ms, plain {parse_plain_ms:.4f} ms; kernel on the whole batch "
          f"({N} rows, longest body {int(args[1].max())} bytes) "
          f"{parse_ms:.4f} ms, bound {whole / HBM_BYTES_PER_S * 1e3:.4f} ms")
    kernels.append(kernel_entry(
        "xh_parse", "tpucomp/kernels/xh_pallas.py:371", parse_err,
        parse_sub_ms, parse_plain_ms,
        int(sub_args[1].clamp(min=0).sum()) + nbytes(*sub_args[1:])
        + nbytes(*parsed_ref)))

    rec_pos, rec_val, p_final, errk = parsed
    fill_in = (rec_pos, rec_val, UNIT, UNIT)
    filled = fill_case(kernels, "XH", fill.fill_records_delta2,
                       fill.fill_records_delta2_ref, fill_in)
    # the zeros unit's row alone (two records: a literal, then one match
    # over the whole row), and every row all literals
    z = len(units) - 1
    fill_case(kernels, "XH, the zeros unit's row alone",
              fill.fill_records_delta2, fill.fill_records_delta2_ref,
              (rec_pos[z:z + 1], rec_val[z:z + 1], UNIT, UNIT))
    gen = torch.Generator(dev).manual_seed(SEED)
    lit = (torch.arange(UNIT, dtype=torch.int32, device=dev).expand(
        N, UNIT).contiguous(), torch.randint(
            0, 256, (N, UNIT), dtype=torch.int32, device=dev, generator=gen))
    fill_case(kernels, "all literals", fill.fill_records_delta2,
              fill.fill_records_delta2_ref, (*lit, UNIT, UNIT))
    del lit
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
    far_row_branches("XH shape, after the probes", len(units))
    tags = [int(((t & (1 << 24)) != 0).sum()) for t in (near, seg, probed)]
    print(f"xh far tags: {tags[0]} after the near walk, {tags[1]} after the "
          f"4 KiB level, {tags[2]} after the probes")
    cases = [
        ("resolve_near", resolve.resolve_near, resolve.resolve_near_ref,
         near_in, (near,), None),
        ("far_level", gather.far_level, gather.far_level_ref, seg_in, (seg,),
         None),
        ("far_row", gather.far_row, gather.far_row_ref, (probed,), (row,),
         "tpucomp/kernels/gather_pallas.py:315"),
    ]
    for name, fn, ref, fargs, got, replaces in cases:
        max_err = compare(name, got, ref(*fargs))
        ms = statistics.median(cuda_ms(lambda: fn(*fargs), reps=10))
        plain_ms = statistics.median(cuda_ms(lambda: ref(*fargs), reps=3))
        moved = nbytes(*(a for a in fargs if isinstance(a, torch.Tensor)),
                       *got)
        print(f"{name} (XH shape {list(fargs[0].shape)}): equal to plain; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms")
        if replaces is None:  # LZNT1's kernel: its entry has LZNT1's times
            fold_err(kernels, name, max_err)
            continue
        kernels.append(kernel_entry(name, replaces, max_err, ms, plain_ms,
                                    moved))
    probe_case(kernels, "XH", seg, ARCHIVE_PROBE_BUDGET)
    # one chain a row through 61440 tags (each points one back), the
    # probe's longest walk: every tag live through every hop
    chain = torch.randint(0, 256, (N, UNIT), dtype=torch.int32, device=dev,
                          generator=gen)
    chain[:, 4096:] = FAR_TAG | torch.arange(4095, UNIT - 1,
                                             dtype=torch.int32, device=dev)
    for r in (1, 2, 5):
        probe_case(kernels, f"chain rows, rounds = {r}", chain, r)
    del parsed, parsed_ref, filled, near_in, near, seg, probed, row, args
    del chain
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
    # the resident decode, stage by stage (each synchronised); the
    # resolved archive's adds the probes before the row level
    for label, b, fast in (("", batch, False),
                           (" fast_resolve", res_batch, True)):
        stages: dict[str, list[float]] = {}
        for _ in range(3):
            t = {}
            probe = [("far_probe", lambda: t.update(s=gather.far_probe(
                t["s"], ARCHIVE_PROBE_BUDGET)))] if fast else []
            for name, fn in (
                    ("tables", lambda: t.update(a=xh.parse_inputs(*b))),
                    ("xh_parse", lambda: t.update(
                        p=xh_parse.xh_parse(*t["a"], UNIT))),
                    ("fill_records", lambda: t.update(
                        f=fill.fill_records_delta2(t["p"][0], t["p"][1],
                                                   UNIT, UNIT))),
                    ("near_inputs (fold)", lambda: t.update(
                        n=xh.near_inputs(t["f"][0], t["f"][1]))),
                    ("resolve_near", lambda: t.update(
                        r=resolve.resolve_near(*t["n"]))),
                    ("far_level", lambda: t.update(s=gather.far_level(
                        t["r"], SEG_LEVEL, SEG_LEVEL_CAP, False))),
                    *probe,
                    ("far_row", lambda: t.update(w=gather.far_row(t["s"])))):
                stages.setdefault(name, []).extend(
                    cuda_ms(fn, reps=1, warmup=0))
            del t
        print(f"xh decode_batch{label} stages, CUDA events, median of 3 "
              "(ms): " + "; ".join(f"{k} {statistics.median(v):.4f}"
                                   for k, v in stages.items()))
    del res_batch
    profile_device("xh decompress_batch", lambda: tpucomp_torch.decompress_batch(
        "xpress_huff", streams, lens, device="cuda"))
    return launches


def encode_phases(dev, data: bytes, native, native_stream: bytes,
                  kernels) -> dict:
    """Phases 7 and 8, LZNT1 encode.  Adds the encode kernels' entries to
    ``kernels`` and returns their launches on the encode main path."""
    import torch

    import tpucomp_torch
    from tpucomp_torch.codecs import lznt1 as lz
    from tpucomp_torch.config import DEFAULT as MATCH
    from tpucomp_torch.kernels import commit, match, runs, sort

    # ---- 7. kernel vs plain ---------------------------------------------------
    chunks_np, clen_np = lz.split_chunks(data)
    chunks = torch.from_numpy(chunks_np).to(dev)
    clen = torch.from_numpy(clen_np).to(dev)
    N, U = chunks.shape
    print(f"encode kernel vs plain at [{N}, {U}] (the corpus's chunks), "
          f"config {MATCH.to_dict()}")

    def check(name, fn, ref, args, reps=20, plain_reps=3):
        got = fn(*args)
        max_err = compare(name, got, ref(*args))
        ms = statistics.median(cuda_ms(lambda: fn(*args), reps=reps))
        plain_ms = statistics.median(cuda_ms(lambda: ref(*args),
                                             reps=plain_reps))
        return got, max_err, ms, plain_ms

    def show(label, ms, plain_ms, moved):
        print(f"{label}: equal to plain; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {moved / HBM_BYTES_PER_S * 1e3:.4f} "
              f"ms ({moved} bytes)")

    disps = tuple(MATCH.run_disps)
    runs_case(kernels, "LZNT1 encode", chunks, disps)

    # the hash sort: the chain keys alone, then the route's word gathers
    key = match.hash_keys(chunks, MATCH.hash_bits, 12)
    hs_err, *_ = sort_case("LZNT1 encode", "sort_rows (hash key, 1 plane)",
                           (key,), reps=20)
    w = match.le_words(chunks)
    nwords = MATCH.cap // 4
    route_ms = statistics.median(cuda_ms(lambda: match.sorted_words(
        w, sort.sort_rows((key,))[0] & (U - 1), nwords), reps=10))
    # reads the key and the word plane, writes the sorted key and the words
    route_moved = 2 * nbytes(key) + (1 + nwords) * nbytes(w)
    print(f"hash sort route (kernel on the key, then {nwords} word gathers): "
          f"{route_ms:.4f} ms, bound "
          f"{route_moved / HBM_BYTES_PER_S * 1e3:.4f} ms")
    del key, w

    spos, packed, _ = match.hash_best_match_sorted(
        chunks, U, MATCH.hash_bits, MATCH.num_candidates, MATCH.cap,
        pos_bits=12)
    un_err, ms, plain_ms, moved, library_ms = sort_case(
        "LZNT1 encode", "sort_rows (un-sort, 2 planes)", (spos, packed),
        reps=20)
    kernels.append(kernel_entry(
        "sort_rows", "tpucomp/kernels/sort_pallas.py:95", max(hs_err, un_err),
        ms, plain_ms, moved, library_ms))
    del spos, packed

    best_len, _, use_match, okpos = lz.find_matches(chunks, clen)
    walk_in = (use_match, best_len, okpos)
    got, lay_err, ms, plain_ms = check(
        "greedy_commit_layout", commit.greedy_commit_layout,
        lambda *a: commit.greedy_commit_ref(*a, layout=True), walk_in,
        plain_reps=1)
    moved = nbytes(*walk_in, *got)
    show(f"greedy_commit_layout ({int(got[0].sum())} tokens)", ms, plain_ms,
         moved)
    walk_rounds("LZNT1 encode", commit.greedy_commit_layout, U)
    _, com_err, com_ms, com_plain_ms = check(
        "greedy_commit", commit.greedy_commit, commit.greedy_commit_ref,
        walk_in, plain_reps=1)
    show("greedy_commit (no layout)", com_ms, com_plain_ms,
         nbytes(*walk_in) + N * U)
    walk_rounds("LZNT1 encode", commit.greedy_commit, U)
    kernels.append(kernel_entry(
        "greedy_commit", "tpucomp/kernels/lz_pallas.py:146",
        max(lay_err, com_err), ms, plain_ms, moved))
    del got, walk_in, best_len, use_match, okpos

    # ---- 8. main path ---------------------------------------------------------
    wrappers = {"run_matchlens": (runs.run_matchlens,),
                "sort_rows": (sort.sort_rows,),
                "greedy_commit": (commit.greedy_commit,
                                  commit.greedy_commit_layout)}

    def reset():
        for fns in wrappers.values():
            for fn in fns:
                fn.launches = 0

    def counts():
        return {k: sum(fn.launches for fn in fns)
                for k, fns in wrappers.items()}

    rng = np.random.default_rng(SEED + 2)
    units = [data[i:i + lz.CHUNK] for i in range(0, len(data), lz.CHUNK)]
    odd = [b"", b"a", b"ab", b"abc", data[:4095], data[12345:13345],
           rng.integers(0, 256, 777, dtype=np.uint8).tobytes()]
    torch.cuda.reset_peak_memory_stats()
    reset()
    stream = tpucomp_torch.compress("lznt1", data)
    one_launches = counts()
    reset()
    got_units = tpucomp_torch.compress_batch("lznt1", units + odd)
    batch_launches = counts()
    print(f"encode main path launches: compress {one_launches}, "
          f"compress_batch {batch_launches}")
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    want = tpucomp_torch.compress("lznt1", data, device="cpu")
    cpu_s = time.perf_counter() - t0
    require(stream == want, "the card's LZNT1 stream differs from the plain "
            "versions' on the CPU")
    print(f"compress: {len(stream)} bytes (ratio {len(stream) / len(data)}; "
          f"native C encoder {len(native_stream)}, ratio "
          f"{len(native_stream) / len(data)}), equal to "
          f"compress(device='cpu') ({cpu_s:.2f} s on the host)")
    require(tpucomp_torch.decompress("lznt1", stream) == data,
            "the card's stream does not decode back through decompress")
    require(native.lznt1_decompress(stream, len(data)) == data,
            "the card's stream does not decode back through the native C "
            "decoder")
    print("compress: the stream decodes back to the input through "
          "tpucomp_torch.decompress and the native C decoder")
    spans = chunk_spans(stream)
    require(len(spans) == len(units) and all(
        got_units[k] == stream[a:b] for k, (a, b) in enumerate(spans)),
        "compress_batch's units differ from compress's chunks")
    require(got_units[len(units)] == b"" and all(
        got_units[len(units) + k] == tpucomp_torch.compress("lznt1", u)
        for k, u in enumerate(odd) if u), "compress_batch's odd units differ "
        "from compress")
    require(tpucomp_torch.decompress_batch("lznt1", got_units)
            == units + odd, "compress_batch's streams do not decode back")
    print(f"compress_batch: {len(units)} units of {lz.CHUNK} bytes equal to "
          f"compress's chunks, {len(odd)} odd units (lengths "
          f"{[len(u) for u in odd]}) equal to compress; all decode back")
    for name in wrappers:
        require(one_launches[name] > 0 and batch_launches[name] > 0,
                f"{name} never launched on the encode main path")
    print(f"encode peak device memory: {peak / 2**30:.3f} GiB")

    total = len(data)
    timed = [
        ("encode_batch (device, batch resident)",
         lambda: lz.encode_batch(chunks, clen)),
        ("compress (host split + copies + device + framing)",
         lambda: tpucomp_torch.compress("lznt1", data)),
        (f"compress_batch ({len(units)} units of 4 KiB)",
         lambda: tpucomp_torch.compress_batch("lznt1", units)),
    ]
    for label, fn in timed:
        ms = cuda_ms(fn, reps=5)
        med = statistics.median(ms)
        print(f"lznt1 {label}: median {med:.4f} ms of "
              f"{[round(m, 4) for m in ms]} -> {total / med / 1e6:.4f} GB/s")
    steps: dict[str, list[float]] = {}
    for _ in range(3):
        c_np, l_np = clock(steps, "split_chunks (host)",
                           lambda: lz.split_chunks(data))
        c, n = clock(steps, "copy to device", lambda: (
            torch.from_numpy(c_np).to(dev), torch.from_numpy(l_np).to(dev)))
        m = clock(steps, "find_matches", lambda: lz.find_matches(c, n))
        wk = clock(steps, "greedy_commit_layout",
                   lambda: commit.greedy_commit_layout(m[2], m[0], m[3]))
        pay = clock(steps, "assemble_payload",
                    lambda: lz.assemble_payload(c, m[0], m[1], m[2], *wk))
        host = clock(steps, "copy to host", lambda: (
            pay[0].cpu().numpy(), pay[1].cpu().numpy()))
        clock(steps, "frame_chunks + join (host)", lambda: b"".join(
            lz.frame_chunks(*host, c_np, l_np)))
        del c, n, m, wk, pay
    print("compress steps, host clock, median of 3 (ms): " + "; ".join(
        f"{k} {statistics.median(v):.4f}" for k, v in steps.items()))
    # find_matches on the device, stage by stage (each synchronised)
    stages: dict[str, list[float]] = {}
    for _ in range(3):
        t = {}
        for name, fn in (
                ("run_matchlens", lambda: runs.run_matchlens(chunks, disps)),
                ("hash keys", lambda: t.update(
                    k=match.hash_keys(chunks, MATCH.hash_bits, 12))),
                ("sort_rows (hash key)", lambda: t.update(
                    s=sort.sort_rows((t["k"],))[0] & (U - 1))),
                ("word gathers", lambda: match.sorted_words(
                    match.le_words(chunks), t["s"], nwords)),
                ("hash_best_match whole", lambda: t.update(
                    h=match.hash_best_match(
                        chunks, U, MATCH.hash_bits, MATCH.num_candidates,
                        MATCH.cap, pos_bits=12))),
                ("extend_saturated", lambda: match.extend_saturated(
                    *t["h"], MATCH.cap, U)),
                ("find_matches whole", lambda: lz.find_matches(chunks, clen))):
            stages.setdefault(name, []).extend(cuda_ms(fn, reps=1, warmup=0))
        del t
    print("find_matches stages, CUDA events, median of 3 (ms): " + "; ".join(
        f"{k} {statistics.median(v):.4f}" for k, v in stages.items()))
    profile_device("compress", lambda: tpucomp_torch.compress("lznt1", data))
    return {k: one_launches[k] + batch_launches[k] for k in wrappers}


def xp_malformed(native, units, streams, idx, rng):
    """N_XP_MALFORMED seeded malformed (stream, out_len) rows made from the
    units ``idx``: streams cut short, flipped bits, a first token that
    copies from before the start, an out_len past the content, short
    random bytes, and a u32 escape length that wraps int32."""
    wrap = bytes([0xFF, 0xFF, 0xFF, 0x4F, 7, 7, 0, 0x0F, 0xFF, 0, 0,
                  0xFD, 0xFF, 0xFF, 0x7F, 8, 9])
    rows = []
    for k in range(N_XP_MALFORMED):
        i = idx[k % len(idx)]
        s, n = streams[i], len(units[i])
        kind = k % 6
        if kind == 0:
            rows.append((s[:int(rng.integers(5, len(s) // 2))], n))
        elif kind == 1:
            b = bytearray(s)
            for pos in rng.integers(4, len(s), 3).tolist():
                b[pos] ^= 1 << int(rng.integers(8))
            rows.append((bytes(b), n))
        elif kind == 2:
            rows.append((s[:3] + bytes([s[3] | 0x80, 8, 0]) + s[6:], n))
        elif kind == 3:
            rows.append((native.xpress_compress(units[i][:n // 2]), n))
        elif kind == 4:
            rows.append((rng.integers(0, 256, 300, dtype=np.uint8).tobytes(),
                         n))
        else:
            rows.append((wrap, 4))
    return rows


def xp_parse_steps(n_corpus) -> None:
    """Print the skeleton walk's steps (flag words and matches) of the rows
    of the parse's last launch on phase 9's batch: the corpus rows (the
    first ``n_corpus``), the random unit and the zeros after them, and the
    malformed rows; then the occupancy the kernel reached."""
    from tpucomp_torch.kernels import _build, xp_parse

    st = xp_parse.xp_parse.steps.cpu()
    parts = [("corpus rows", st[:n_corpus]),
             ("random unit", st[n_corpus:n_corpus + 1]),
             ("zeros unit", st[n_corpus + 1:n_corpus + 2]),
             ("malformed rows", st[n_corpus + 2:])]
    print("xp_parse skeleton steps per row: " + "; ".join(
        f"{label} ({len(v)}): max {int(v.max())}, mean "
        f"{float(v.float().mean()):.4f}" for label, v in parts))
    out = (ctypes.c_int * 6)()
    lib = ctypes.CDLL(_build.build()[0])
    require(lib.xp_parse_occupancy(out) == 0, "xp_parse_occupancy failed")
    print(f"xp_parse occupancy: {out[0]} blocks (rows) an SM, {out[1]} "
          f"registers a thread, {out[2]} bytes of shared memory a block "
          f"(byte-load build: {out[3]}, {out[4]}, {out[5]})")


def xp_parse_alone(dev, batch, n_corpus, native, rng) -> None:
    """Time the parse on phase 9's random unit alone, and on a batch of
    514 units of seeded random bytes (every row about 2,048 flag words,
    nearly all of 32 literals: the most records for the emission), which
    must decode back."""
    import torch

    from tpucomp_torch.codecs import xpress as xp
    from tpucomp_torch.kernels import xp_parse

    one = tuple(a[n_corpus:n_corpus + 1] for a in batch)
    one_ms = statistics.median(cuda_ms(
        lambda: xp_parse.xp_parse(*one, UNIT), reps=10))
    rand = [rng.integers(0, 256, UNIT, dtype=np.uint8).tobytes()
            for _ in range(n_corpus + 2)]
    rb = xp.pack_units([native.xpress_compress(u) for u in rand],
                       [UNIT] * len(rand), UNIT, dev)
    out, err = xp.decode_batch(*rb, UNIT)
    want = torch.from_numpy(np.frombuffer(b"".join(rand), np.uint8).reshape(
        len(rand), UNIT)).to(dev)
    require(not bool(err.any()) and torch.equal(out, want),
            "the random units do not decode back")
    many_ms = statistics.median(cuda_ms(
        lambda: xp_parse.xp_parse(*rb, UNIT), reps=5))
    st = xp_parse.xp_parse.steps
    # as phase 9's bound: the payload as far as plen, the record planes
    moved = int(rb[1].sum()) + nbytes(*rb[1:], *xp_parse.xp_parse(*rb, UNIT))
    print(f"xp_parse: the random unit alone {one_ms:.4f} ms; "
          f"{len(rand)} random units ({rb[0].shape[1]} payload bytes a row, "
          f"skeleton steps {int(st.min())} to {int(st.max())}) "
          f"{many_ms:.4f} ms, decoding back, bound "
          f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms")


def xpress_phases(dev, units, native, kernels) -> dict:
    """Phases 9 and 10, plain Xpress.  Adds the parse's entry to
    ``kernels`` (and the Xpress comparisons of the other kernels to
    theirs) and returns the launches of every kernel on the Xpress main
    path."""
    import torch

    import tpucomp_torch
    from tpucomp_torch.codecs import xpress as xp
    from tpucomp_torch.codecs.xpress_huff import near_inputs
    from tpucomp_torch.config import DEFAULT as MATCH
    from tpucomp_torch.kernels import (commit, fill, gather, match, resolve,
                                       runs, sort, xp_parse)
    from tpucomp_torch.kernels.common import SEG_LEVEL, SEG_LEVEL_CAP

    rng = np.random.default_rng(SEED + 3)
    units = list(units) + [
        rng.integers(0, 256, UNIT, dtype=np.uint8).tobytes(), bytes(UNIT)]
    t0 = time.perf_counter()
    streams = [native.xpress_compress(u) for u in units]
    lens = [len(u) for u in units]
    total = sum(lens)
    sizes = sorted(len(x) for x in streams)
    print(f"xpress: {len(units)} units of {UNIT} bytes (the corpus's "
          f"{len(units) - 2}, one of seeded random bytes, one of zeros) "
          f"encode to {sum(sizes)} bytes by the native C encoder (ratio "
          f"{sum(sizes) / total}), streams {sizes[0]} to {sizes[-1]} bytes "
          f"(median {sizes[len(sizes) // 2]}), "
          f"{time.perf_counter() - t0:.2f} s to encode")

    def entry(name, fn, ref, args, reps=10, plain_reps=3):
        """:func:`hold_to_plain`, its comparison folded into the kernel's
        existing entry (which keeps the times of its first slice)."""
        got, max_err, *_ = hold_to_plain("Xpress", name, fn, ref, args, reps,
                                         plain_reps)
        fold_err(kernels, name, max_err)
        return got

    # ---- 9. kernel vs plain: decode -------------------------------------------
    n_corpus = len(units) - 2
    shortest = sorted(range(n_corpus), key=lambda i: len(streams[i]))[
        :XP_SUB_SHORTEST]
    bad = xp_malformed(native, units, streams, shortest, rng)
    rows = list(zip(streams, lens)) + bad
    batch = xp.pack_units([r[0] for r in rows], [r[1] for r in rows], UNIT,
                          dev)
    N, P = batch[0].shape
    print(f"xpress kernel vs plain at N={N} ({N_XP_MALFORMED} malformed "
          f"rows), payload width {P}")
    parsed = xp_parse.xp_parse(*batch, UNIT)
    sub = torch.tensor(shortest + list(range(len(units), N)), device=dev)
    sub_args = tuple(a[sub] for a in batch)
    ref_out = []
    parse_plain_ms, = cuda_ms(lambda: ref_out.append(
        xp_parse.xp_parse_ref(*sub_args, UNIT)), reps=1, warmup=0)
    parsed_ref, = ref_out
    parse_err = max(
        compare("xp_parse", xp_parse.xp_parse(*sub_args, UNIT), parsed_ref),
        compare("xp_parse", tuple(p[sub] for p in parsed), parsed_ref))
    parse_sub_ms = statistics.median(cuda_ms(
        lambda: xp_parse.xp_parse(*sub_args, UNIT), reps=5))
    parse_ms = statistics.median(cuda_ms(
        lambda: xp_parse.xp_parse(*batch, UNIT), reps=5))
    # the payload bytes as far as each row's length, the rest of the inputs
    # and the record planes whole (the whole batch here, the sub-batch in
    # the kernel's entry)
    whole = int(batch[1].sum()) + nbytes(*batch[1:], *parsed)
    print(f"xp_parse: equal to plain on a sub-batch of {len(sub)} rows (the "
          f"{XP_SUB_SHORTEST} shortest corpus streams and the malformed rows, "
          f"longest {int(sub_args[1].max())} bytes): kernel "
          f"{parse_sub_ms:.4f} ms, plain {parse_plain_ms:.4f} ms; kernel on "
          f"the whole batch ({N} rows, longest {int(batch[1].max())} bytes, "
          f"{int(batch[1].sum())} in all) {parse_ms:.4f} ms, bound "
          f"{whole / HBM_BYTES_PER_S * 1e3:.4f} ms")
    xp_parse_steps(n_corpus)
    xp_parse_alone(dev, batch, n_corpus, native, rng)
    kernels.append(kernel_entry(
        "xp_parse", "tpucomp/kernels/xp_pallas.py:211", parse_err,
        parse_sub_ms, parse_plain_ms,
        int(sub_args[1].sum()) + nbytes(*sub_args[1:], *parsed_ref)))
    rec_pos, rec_val, p_final, errk = parsed
    err = (errk != 0) | (p_final < batch[2])
    require(not bool(err[:len(units)].any()),
            "a well-formed Xpress unit parsed with err set")
    print(f"xpress: {int(err.sum())} rows with err ({N_XP_MALFORMED} "
          "malformed rows injected)")
    fill_in = (rec_pos, rec_val, UNIT)
    filled = fill_case(kernels, "Xpress", fill.fill_records_delta2,
                       fill.fill_records_delta2_ref, fill_in)
    z = len(units) - 1
    fill_case(kernels, "Xpress, the zeros unit's row alone",
              fill.fill_records_delta2, fill.fill_records_delta2_ref,
              (rec_pos[z:z + 1], rec_val[z:z + 1], UNIT))
    near_in = near_inputs(filled[0], filled[1])
    near = entry("resolve_near", resolve.resolve_near,
                 resolve.resolve_near_ref, near_in, reps=5)
    seg_in = (near, SEG_LEVEL, SEG_LEVEL_CAP, False)
    seg = far_level_case(kernels, "Xpress, the 4 KiB level", seg_in)
    entry("far_row", gather.far_row, gather.far_row_ref, (seg,), reps=5)
    far_row_branches("Xpress shape, after the 4 KiB level", len(units))
    del parsed, parsed_ref, filled, near_in, near, seg, sub_args
    del rec_pos, rec_val, fill_in, seg_in

    # ---- 9. kernel vs plain: encode -------------------------------------------
    units_np = np.zeros((len(units), UNIT), np.uint8)
    for i, u in enumerate(units):
        units_np[i, :len(u)] = np.frombuffer(u, np.uint8)
    x = torch.from_numpy(units_np).to(dev)
    ulen = torch.tensor(lens, dtype=torch.int32, device=dev)
    disps = tuple(MATCH.run_disps)
    runs_case(kernels, "Xpress encode", x, disps)
    # runs across every tile edge (all zeros: one run a row), the zeros
    # unit's row alone, and random bytes (no run crosses an edge)
    runs_case(kernels, "all-zero rows", torch.zeros_like(x), disps)
    runs_case(kernels, "the zeros unit's row alone", x[-1:], disps)
    gen = torch.Generator(dev).manual_seed(SEED)
    runs_case(kernels, "random rows", torch.randint(
        0, 256, x.shape, dtype=torch.uint8, device=dev, generator=gen), disps)

    key = match.hash_keys(x, MATCH.hash_bits, 16)
    err, *_ = sort_case("Xpress", "sort_rows (hash key, 1 plane)", (key,))
    fold_err(kernels, "sort_rows", err)
    del key
    spos, packed, _ = match.hash_best_match_sorted(
        x, UNIT, MATCH.hash_bits, MATCH.num_candidates, MATCH.cap,
        max_disp=xp.WINDOW)
    err, *_ = sort_case("Xpress", "sort_rows (un-sort, 2 planes)",
                        (spos, packed))
    fold_err(kernels, "sort_rows", err)
    del spos, packed
    best_len, _, use_match, okpos = xp.find_matches(x, ulen)
    committed = entry("greedy_commit (no layout)", commit.greedy_commit,
                      commit.greedy_commit_ref, (use_match, best_len, okpos),
                      plain_reps=1)
    print(f"greedy_commit: {int(committed.sum())} tokens")
    walk_rounds("Xpress", commit.greedy_commit, UNIT)
    # the same shape with no chain (staging and stores, 2 rounds of one
    # step) and all literals (one round, every segment walks 128 steps)
    for label, ok, m in (("okpos all false", False, use_match),
                         ("all literals", okpos, torch.zeros_like(use_match))):
        args = (m, best_len, okpos & ok)
        ms = statistics.median(cuda_ms(lambda: commit.greedy_commit(*args),
                                       reps=10))
        r = commit.greedy_commit.rounds
        print(f"greedy_commit (Xpress shape, {label}): kernel {ms:.4f} ms, "
              f"rounds per row max {int(r.max())}")
    del best_len, use_match, okpos, committed

    # ---- 10. main path --------------------------------------------------------
    wrappers = {"xp_parse": (xp_parse.xp_parse,),
                "fill_records": (fill.fill_records_delta2,),
                "resolve_near": (resolve.resolve_near,),
                "far_level": (gather.far_level,),
                "far_row": (gather.far_row,),
                "run_matchlens": (runs.run_matchlens,),
                "sort_rows": (sort.sort_rows,),
                "greedy_commit": (commit.greedy_commit,)}
    for fns in wrappers.values():
        for fn in fns:
            fn.launches = 0
    corrupt = streams[0][:3] + bytes([streams[0][3] | 0x80, 8, 0]) \
        + streams[0][6:]
    oneshot = units[0][:50000]
    torch.cuda.reset_peak_memory_stats()
    out = tpucomp_torch.decompress_batch("xpress", streams, lens,
                                         device="cuda")
    dec_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    enc = tpucomp_torch.compress_batch("xpress", units, device="cuda")
    enc_peak = torch.cuda.max_memory_allocated()
    one = tpucomp_torch.compress("xpress", oneshot, device="cuda")
    one_back = tpucomp_torch.decompress("xpress", one, len(oneshot),
                                        device="cuda")
    try:
        tpucomp_torch.decompress_batch("xpress", [corrupt], [UNIT],
                                       device="cuda")
        raised = False
    except tpucomp_torch.DataError:
        raised = True
    launches = {k: sum(fn.launches for fn in fns)
                for k, fns in wrappers.items()}
    print(f"xpress main path launches: {launches}")
    require(out == units, "xpress decompress_batch output differs from the "
            "units")
    for i in sorted(rng.choice(len(units), min(16, len(units)),
                               replace=False).tolist()):
        require(native.xpress_decompress(streams[i], lens[i]) == out[i],
                f"xpress unit {i} differs from the native C decoder")
    print(f"xpress decompress_batch: {len(units)} units equal to the input; "
          f"{min(16, len(units))} sampled units equal to the native C "
          "decoder")
    t0 = time.perf_counter()
    want = tpucomp_torch.compress_batch("xpress", units, device="cpu")
    cpu_s = time.perf_counter() - t0
    require(enc == want, "the card's Xpress streams differ from the plain "
            "versions' on the CPU")
    back = tpucomp_torch.decompress_batch("xpress", enc, lens, device="cuda")
    require(back == units, "the card's Xpress streams do not decode back "
            "through decompress_batch")
    require(all(native.xpress_decompress(s, n) == u
                for s, n, u in zip(enc, lens, units)),
            "the card's Xpress streams do not decode back through the native "
            "C decoder")
    enc_bytes = sum(map(len, enc))
    print(f"xpress compress_batch: {enc_bytes} bytes (ratio "
          f"{enc_bytes / total}; native C encoder {sum(sizes)}, ratio "
          f"{sum(sizes) / total}), all {len(units)} units equal to "
          f"compress_batch(device='cpu') ({cpu_s:.2f} s on the host) and "
          "decoding back through the port and the native C decoder")
    require(one_back == oneshot and one == tpucomp_torch.compress_batch(
        "xpress", [oneshot], device="cuda")[0], "the one-shot Xpress round "
        "trip failed")
    print(f"xpress one-shot: {len(oneshot)} bytes -> {len(one)} -> back")
    require(raised, "a corrupt Xpress unit did not raise DataError")
    print("xpress corrupt unit: DataError raised")
    for name, n in launches.items():
        require(n > 0, f"{name} never launched on the Xpress main path")
    print(f"xpress peak device memory: decompress_batch "
          f"{dec_peak / 2**30:.3f} GiB, compress_batch "
          f"{enc_peak / 2**30:.3f} GiB")

    dec_batch = xp.pack_units(streams, lens, UNIT, dev)
    timed = [
        ("decode_batch (device, batch resident)",
         lambda: xp.decode_batch(*dec_batch, UNIT)),
        ("decompress_batch (host pack + copies + device)",
         lambda: tpucomp_torch.decompress_batch("xpress", streams, lens,
                                                device="cuda")),
        ("encode_batch (device, batch resident)",
         lambda: xp.encode_batch(x, ulen)),
        ("compress_batch (host batch + copies + device)",
         lambda: tpucomp_torch.compress_batch("xpress", units,
                                              device="cuda")),
    ]
    for label, fn in timed:
        ms = cuda_ms(fn, reps=5)
        med = statistics.median(ms)
        print(f"xpress {label}: median {med:.4f} ms of "
              f"{[round(m, 4) for m in ms]} -> {total / med / 1e6:.4f} GB/s")
    stages: dict[str, list[float]] = {}
    for _ in range(3):
        t = {}
        for name, fn in (
                ("xp_parse", lambda: t.update(p=xp_parse.xp_parse(
                    *dec_batch, UNIT))),
                ("fill_records", lambda: t.update(f=fill.fill_records_delta2(
                    t["p"][0], t["p"][1], UNIT))),
                ("near_inputs (fold)", lambda: t.update(
                    n=near_inputs(t["f"][0], t["f"][1]))),
                ("resolve_near", lambda: t.update(
                    r=resolve.resolve_near(*t["n"]))),
                ("far_level", lambda: t.update(s=gather.far_level(
                    t["r"], SEG_LEVEL, SEG_LEVEL_CAP, False))),
                ("far_row", lambda: gather.far_row(t["s"])),
                ("run_matchlens", lambda: runs.run_matchlens(x, disps)),
                ("hash_best_match", lambda: t.update(h=match.hash_best_match(
                    x, UNIT, MATCH.hash_bits, MATCH.num_candidates, MATCH.cap,
                    max_disp=xp.WINDOW))),
                ("extend_saturated", lambda: match.extend_saturated(
                    *t["h"], MATCH.cap, UNIT)),
                ("find_matches whole", lambda: t.update(
                    m=xp.find_matches(x, ulen))),
                ("greedy_commit", lambda: t.update(c=commit.greedy_commit(
                    t["m"][2], t["m"][0], t["m"][3]))),
                ("assemble_payload", lambda: xp.assemble_payload(
                    x, *t["m"][:3], t["c"]))):
            stages.setdefault(name, []).extend(cuda_ms(fn, reps=1, warmup=0))
        del t
    print("xpress stages, CUDA events, median of 3 (ms): " + "; ".join(
        f"{k} {statistics.median(v):.4f}" for k, v in stages.items()))
    profile_device("xpress decompress_batch",
                   lambda: tpucomp_torch.decompress_batch(
                       "xpress", streams, lens, device="cuda"))
    profile_device("xpress compress_batch",
                   lambda: tpucomp_torch.compress_batch(
                       "xpress", units, device="cuda"))
    return launches


def launch_counters() -> list:
    """Every kernel wrapper of the port: the functions of
    ``tpucomp_torch.kernels`` that count their launches."""
    import importlib
    import pkgutil

    import tpucomp_torch.kernels as pkg

    fns = []
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        fns += [f for f in vars(mod).values() if callable(f)
                and hasattr(f, "launches") and f.__module__ == mod.__name__]
    return fns


def xh_encode_phases(dev, units, native, kernels) -> dict:
    """Phases 11 and 12, XH encode.  Adds the row gather's entry to
    ``kernels`` (and the XH comparisons of the run matcher, row sort and
    walk to theirs) and returns the launches of every kernel on the XH
    encode main path."""
    import torch

    import tpucomp_torch
    from tpucomp_torch.codecs import xpress as xp
    from tpucomp_torch.codecs import xpress_huff as xh
    from tpucomp_torch.config import DEFAULT as MATCH
    from tpucomp_torch.kernels import commit, gather, match, runs, sort

    units = xh_units(units, np.random.default_rng(SEED + 1))  # phase 5's
    lens = [len(u) for u in units]
    total = sum(lens)
    units_np = np.zeros((len(units), UNIT), np.uint8)
    for i, u in enumerate(units):
        units_np[i] = np.frombuffer(u, np.uint8)
    x = torch.from_numpy(units_np).to(dev)
    ulen = torch.tensor(lens, dtype=torch.int32, device=dev)
    N = x.shape[0]

    # ---- 11. kernel vs plain --------------------------------------------------
    def check(label, fn, ref, args, reps=10, plain_reps=1):
        got, max_err, *_ = hold_to_plain("XH encode", label, fn, ref, args,
                                         reps, plain_reps)
        fold_err(kernels, label, max_err)
        return got

    print(f"xh encode kernel vs plain at [{N}, {UNIT}] (the units of phase 5), "
          f"config {MATCH.to_dict()}")
    disps = tuple(MATCH.run_disps)
    runs_case(kernels, "XH encode", x, disps)
    key = match.hash_keys(x, MATCH.hash_bits, 16)
    err, *_ = sort_case("XH encode", "sort_rows (hash key, 1 plane)", (key,))
    fold_err(kernels, "sort_rows", err)
    del key
    spos, packed, _ = match.hash_best_match_sorted(
        x, UNIT, MATCH.hash_bits, MATCH.num_candidates, MATCH.cap)
    err, *_ = sort_case("XH encode", "sort_rows (un-sort, 2 planes)",
                        (spos, packed))
    fold_err(kernels, "sort_rows", err)
    del spos, packed
    best_len, best_disp, use_match, okpos = xp.find_matches(x, ulen,
                                                            max_disp=None)
    committed = check("greedy_commit (no layout)", commit.greedy_commit,
                      commit.greedy_commit_ref, (use_match, best_len, okpos))
    walk_rounds("XH encode", commit.greedy_commit, UNIT)
    sym = xh.symbols(x, best_len, best_disp, use_match, committed)
    lengths, codes = xh.code_tables(sym)
    print(f"xh encode: {int(committed.sum())} tokens, "
          f"{int((sym < 256).sum())} literals")
    # the lookup: (code << 5) | length of each position's symbol
    table = (codes << 5) | lengths
    idx = sym.clamp(max=xh.NUM_SYMBOLS - 1)
    lookup_in = (table, idx, 20)
    _, err512, ms512, plain512, moved512 = hold_to_plain(
        "XH encode", "gather_rows (lookup, K = 512)", gather.gather_rows,
        gather.gather_rows_ref, lookup_in, reps=20)
    idx64 = idx.long()
    lib512 = statistics.median(cuda_ms(lambda: torch.gather(table, 1, idx64),
                                       reps=20))
    print(f"gather_rows (lookup): torch.gather (int64 index made before) "
          f"{lib512:.4f} ms")
    del idx64
    # the TPU kernel's own shape: a 64 KiB table of full 32-bit words,
    # 65536 seeded in-range queries a row
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    wide = match.le_words(x)
    widx = torch.randint(0, UNIT, (N, UNIT), generator=gen, device=dev,
                         dtype=torch.int32)
    _, err64k, *_ = hold_to_plain(
        "XH encode", "gather_rows (K = 65536)", gather.gather_rows,
        gather.gather_rows_ref, (wide, widx, 32), reps=20)
    widx64 = widx.long()
    lib64k = statistics.median(cuda_ms(lambda: torch.gather(wide, 1, widx64),
                                       reps=20))
    print(f"gather_rows (K = 65536): torch.gather (int64 index made before) "
          f"{lib64k:.4f} ms")
    del wide, widx, widx64
    kernels.append(kernel_entry(
        "gather_rows", "tpucomp/kernels/gather_pallas.py:343",
        max(err512, err64k), ms512, plain512, moved512, lib512))
    del best_len, best_disp, use_match, okpos, committed, sym, lengths
    del codes, table, idx, lookup_in

    # ---- 12. main path ---------------------------------------------------------
    wrappers = {"run_matchlens": (runs.run_matchlens,),
                "sort_rows": (sort.sort_rows,),
                "greedy_commit": (commit.greedy_commit,
                                  commit.greedy_commit_layout),
                "gather_rows": (gather.gather_rows,)}
    rng = np.random.default_rng(SEED + 4)
    n_corpus = len(units) - 2
    sub_idx = sorted(rng.choice(n_corpus, XHE_SUB_CORPUS,
                                replace=False).tolist()) + [n_corpus,
                                                            n_corpus + 1]
    short = units[sub_idx[0]][:12345]
    sub = [units[i] for i in sub_idx] + [short]
    data = b"".join(units[:4])[:ONESHOT_BYTES]
    blocks = [data[i:i + xh.BLOCK] for i in range(0, len(data), xh.BLOCK)]
    for fn in launch_counters():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    enc = tpucomp_torch.compress_batch("xpress_huff", units)
    peak = torch.cuda.max_memory_allocated()
    one = tpucomp_torch.compress("xpress_huff", data)
    sub_enc = tpucomp_torch.compress_batch("xpress_huff", sub)
    launches = {k: sum(fn.launches for fn in fns)
                for k, fns in wrappers.items()}
    print(f"xh encode main path launches: {launches}")
    t0 = time.perf_counter()
    want = tpucomp_torch.compress_batch("xpress_huff", sub, device="cpu")
    cpu_s = time.perf_counter() - t0
    require(sub_enc == want, "the card's XH streams differ from the plain "
            "versions' on the CPU")
    require(sub_enc[:-1] == [enc[i] for i in sub_idx], "the sub-batch's "
            "streams differ from the whole batch's")
    print(f"xh compress_batch: a sub-batch of {len(sub)} units "
          f"({XHE_SUB_CORPUS} from the corpus, the random one, the zeros, "
          f"one of {len(short)} bytes) equal to compress_batch(device='cpu') "
          f"({cpu_s:.2f} s on the host) and to the whole batch's rows")
    back = tpucomp_torch.decompress_batch("xpress_huff", enc, lens)
    require(back == units, "the card's XH streams do not decode back through "
            "decompress_batch")
    for i in sorted(rng.choice(len(units), min(16, len(units)),
                               replace=False).tolist()):
        require(native.xh_decompress(enc[i], lens[i]) == units[i],
                f"xh encoded unit {i} does not decode back through the "
                "native C decoder")
    enc_bytes = sum(map(len, enc))
    native_bytes = sum(len(native.xh_compress(u)) for u in units)
    print(f"xh compress_batch: {len(units)} units -> {enc_bytes} bytes (ratio "
          f"{enc_bytes / total}; native C encoder {native_bytes}, ratio "
          f"{native_bytes / total}); all decode back through "
          "decompress_batch on the card, 16 sampled through the native C "
          "decoder")
    one_blocks = tpucomp_torch.compress_batch("xpress_huff", blocks)
    require(one == b"".join(one_blocks), "the one-shot XH stream is not its "
            "blocks' streams joined")
    require(tpucomp_torch.decompress_batch(
        "xpress_huff", one_blocks, [len(b) for b in blocks]) == blocks,
        "a block of the one-shot XH stream does not decode back")
    require(native.xh_decompress(one, len(data)) == data,
            "the one-shot XH stream does not decode back through the native "
            "C decoder")
    print(f"xh one-shot compress: {len(data)} bytes, {len(blocks)} blocks -> "
          f"{len(one)} bytes; each block decodes back, the whole stream "
          "through the native C decoder")
    for name, n in launches.items():
        require(n > 0, f"{name} never launched on the XH encode main path")
    print(f"xh encode peak device memory (compress_batch): "
          f"{peak / 2**30:.3f} GiB")

    timed = [
        ("encode_batch (device, batch resident)",
         lambda: xh.encode_batch(x, ulen)),
        ("compress_batch (host batch + copies + device)",
         lambda: tpucomp_torch.compress_batch("xpress_huff", units)),
    ]
    for label, fn in timed:
        ms = cuda_ms(fn, reps=5)
        med = statistics.median(ms)
        print(f"xh {label}: median {med:.4f} ms of "
              f"{[round(m, 4) for m in ms]} -> {total / med / 1e6:.4f} GB/s")
    stages: dict[str, list[float]] = {}
    for _ in range(3):
        t = {}
        for name, fn in (
                ("find_matches", lambda: t.update(m=xp.find_matches(
                    x, ulen, max_disp=None))),
                ("greedy_commit", lambda: t.update(c=commit.greedy_commit(
                    t["m"][2], t["m"][0], t["m"][3]))),
                ("symbols", lambda: t.update(s=xh.symbols(
                    x, *t["m"][:3], t["c"]))),
                ("histogram + lengths + codes", lambda: t.update(
                    h=xh.code_tables(t["s"]))),
                ("lookup (gather_rows)", lambda: t.update(
                    g=xh.lookup(*t["h"], t["s"]))),
                ("layout + assembly", lambda: xh.assemble_payload(
                    *t["m"][:3], t["c"], t["h"][0], t["g"]))):
            stages.setdefault(name, []).extend(cuda_ms(fn, reps=1, warmup=0))
        del t
    print("xh encode stages, CUDA events, median of 3 (ms): " + "; ".join(
        f"{k} {statistics.median(v):.4f}" for k, v in stages.items()))
    profile_device("xh compress_batch", lambda: tpucomp_torch.compress_batch(
        "xpress_huff", units))
    return launches


def shape_entry(kernels, name, where, got, **extra) -> None:
    """Fold :func:`hold_to_plain`'s result ``got`` (output, max abs err,
    kernel ms, plain ms, bytes moved) into kernel ``name``'s entry, as a
    shape of its ``shapes`` (with ``extra``)."""
    _, max_err, ms, plain_ms, moved = got
    k = next(k for k in kernels if k["name"] == name)
    k["max_abs_err"] = max(k["max_abs_err"], max_err)
    k.setdefault("shapes", []).append({
        "where": where, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3, **extra})


def xh_oneshot_phases(dev, data: bytes, native, kernels) -> dict:
    """Phases 13 and 14, the one-shot XH decode.  Adds this path's
    comparisons to the entries of the kernels it runs (as ``shapes``) and
    returns the launches of every kernel on its main path."""
    import torch

    import tpucomp_torch
    from benchmarks.corpus import _synthetic
    from tpucomp_torch.codecs import xpress_huff as xh
    from tpucomp_torch.kernels import fill, gather, resolve, xh_parse
    from tpucomp_torch.kernels.common import SEG_LEVEL, SEG_LEVEL_CAP

    t0 = time.perf_counter()
    whole = native.xh_compress(data)
    spec_data = data[:XH_SPEC_BYTES]
    spec = native.xh_compress(spec_data)
    ten_data = data[:XH_TEN_BLOCKS]
    ten = native.xh_compress(ten_data)
    print(f"xh one-shot: the corpus ({len(data)} bytes) encodes to "
          f"{len(whole)} bytes, its first {XH_SPEC_BYTES} to {len(spec)}, "
          f"its first {XH_TEN_BLOCKS} to {len(ten)} (native C XH "
          f"encoder, {time.perf_counter() - t0:.2f} s)")
    vec_data = _synthetic(3 * UNIT)
    require(hashlib.sha256(vec_data).hexdigest() == XH_VECTOR_INPUT_SHA256,
            "the cross-block vector's input has another sha256")
    with open(os.path.join(ROOT, XH_VECTOR), "rb") as f:
        vec = f.read()
    print(f"xh one-shot: the cross-block vector {XH_VECTOR}, {len(vec)} "
          f"bytes for {len(vec_data)} (sha256 of the input "
          f"{XH_VECTOR_INPUT_SHA256})")

    # ---- 13. kernel vs plain ------------------------------------------------
    # the speculative batch of the 8 MiB stream: every Kraft candidate, a
    # full block over an all-zero history of full reach
    cands = xh._kraft_candidates(np.frombuffer(spec, np.uint8))
    require(cands is not None, "the 8 MiB stream has over 512 candidates")
    offs = [int(o) for o in cands]
    n = len(offs)
    P = xh.batch_width(len(spec), offs)
    batch = xh.history_batch(spec, offs, [UNIT] * n, [None] * n, [UNIT] * n,
                             P, dev)
    args = xh.parse_inputs(*batch[:4])
    hl = batch[5]
    parsed = xh_parse.xh_parse(*args, UNIT, hist_len=hl, want_span=True)
    rounds = xh_parse.xh_parse.rounds.float()
    rec_pos, rec_val, p_final, errk, span = parsed
    filled = fill.fill_records_delta2(rec_pos, rec_val, UNIT, UNIT)
    ok = (errk == 0) & (filled[2] == 0) & (p_final >= batch[2])
    print(f"xh one-shot speculative batch: {n} candidates ({int(ok.sum())} "
          f"without err) in [{n}, {P}] slices, substep tier "
          f"{int(batch[3][0])}; xh_parse rounds per row max "
          f"{int(rounds.max())}, mean {float(rounds.mean()):.4f} (rows "
          f"without err: max {int(rounds[ok].max())}, mean "
          f"{float(rounds[ok].mean()):.4f})")
    def parse_need(a, outs, ok):
        """The bytes the parse must move: each row's body as far as its
        span (all of it on a row with err), the rest of its inputs and its
        outputs once."""
        body = torch.where(ok, outs[4].clamp(max=a[1]), a[1]).clamp(min=0)
        return int(body.sum()) + nbytes(*a[1:], *outs)

    parse_ms = statistics.median(cuda_ms(lambda: xh_parse.xh_parse(
        *args, UNIT, hist_len=hl, want_span=True), reps=5))
    need = parse_need(args + (hl,), parsed, ok)
    print(f"xh_parse (XH one-shot, the whole speculative batch): "
          f"{parse_ms:.4f} ms, bound {need / HBM_BYTES_PER_S * 1e3:.4f} ms")

    def hold_parse(where, a):
        """The parse with hist_len (a's last) and the span against its
        plain version, which loops once per body byte: timed once, its
        output the one compared."""
        want = []
        plain_ms, = cuda_ms(lambda: want.append(xh_parse.xh_parse_ref(
            *a[:-1], UNIT, a[-1], True)), reps=1, warmup=0)
        got = xh_parse.xh_parse(*a[:-1], UNIT, hist_len=a[-1],
                                want_span=True)
        max_err = compare("xh_parse", got, want[0])
        ms = statistics.median(cuda_ms(lambda: xh_parse.xh_parse(
            *a[:-1], UNIT, hist_len=a[-1], want_span=True), reps=5))
        moved = parse_need(a, got, got[3] == 0)
        r = xh_parse.xh_parse.rounds
        print(f"xh_parse ({where}, [{a[0].shape[0]}, {a[0].shape[1]}], "
              f"longest body {int(a[1].max())} bytes, spans "
              f"{got[4].tolist()}): equal to plain; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound "
              f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms; rounds {r.tolist()}")
        shape_entry(kernels, "xh_parse", where,
                    (got, max_err, ms, plain_ms, moved))
        return got

    # the eight rows without err whose spans are the shortest, and the
    # vector's fixpoint batch (each block over the true output before it)
    short = torch.argsort(torch.where(ok, span, 1 << 30))[:8]
    hold_parse("XH one-shot, the 8 shortest speculative rows",
               tuple(a[short] for a in args) + (hl[short],))
    voffs = [int(o) for o in xh._kraft_candidates(np.frombuffer(vec,
                                                                np.uint8))]
    vb = xh.history_batch(
        vec, voffs, [UNIT] * 3, [None, vec_data[:UNIT],
                                 vec_data[UNIT:2 * UNIT]], [0, UNIT, UNIT],
        xh.batch_width(len(vec), voffs), dev)
    got = hold_parse("XH one-shot, the vector's fixpoint batch",
                     xh.parse_inputs(*vb[:4]) + (vb[5],))
    require(not bool(got[3].any()), "a vector block parsed with err")

    planes = xh.history_planes(*xh.near_inputs(filled[0], filled[1]),
                               batch[4])
    where = f"XH one-shot [{n}, {2 * UNIT}]"
    got = hold_to_plain(where, "resolve_near", resolve.resolve_near,
                        resolve.resolve_near_ref, planes)
    shape_entry(kernels, "resolve_near", where, got)
    seg_in = (got[0], SEG_LEVEL, SEG_LEVEL_CAP, False)
    seg = far_level_case(kernels, where, seg_in)
    got = hold_to_plain(where, "far_row", gather.far_row,
                        gather.far_row_ref, (seg,))
    shape_entry(kernels, "far_row", where, got)
    looped = gather.far_row.looped.bool()
    print(f"far_row branches ({where}): rows without err swept "
          f"{int((ok & ~looped).sum())}, round loop "
          f"{int((ok & looped).sum())}; rows with err swept "
          f"{int((~ok & ~looped).sum())}, round loop "
          f"{int((~ok & looped).sum())}")
    require(not bool((ok & looped).any()),
            "a row without err took far_row's round loop (XH one-shot)")
    first = got[0][offs.index(0), UNIT:].to(torch.uint8).cpu().numpy()
    require(bool(ok[offs.index(0)]) and first.tobytes() == spec_data[:UNIT],
            "the speculative batch's first block differs from the input")
    del parsed, filled, planes, got, batch, args, vb, first, seg, seg_in

    # ---- 14. main path --------------------------------------------------------
    counters = launch_counters()
    path = ("xh_parse", "fill_records_delta2", "resolve_near", "far_level",
            "far_row")
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    calls = {"8 MiB (speculative)": (spec, spec_data),
             f"{XH_TEN_BLOCKS} bytes (tpucomp's test shape)": (ten, ten_data),
             "the whole corpus (513 blocks)": (whole, data),
             "the cross-block vector": (vec, vec_data)}
    outs, stats = {}, {}
    for label, (stream, want) in calls.items():
        outs[label] = tpucomp_torch.decompress("xpress_huff", stream,
                                               len(want), device="cuda")
        stats[label] = dict(xh.decompress.stats)
    try:
        tpucomp_torch.decompress("xpress_huff", spec[:len(spec) // 2],
                                 len(spec_data), device="cuda")
        raised = False
    except tpucomp_torch.DataError:
        raised = True
    launches = {fn.__name__: fn.launches for fn in counters
                if fn.launches}
    print(f"xh one-shot main path launches: {launches}")
    for label, (stream, want) in calls.items():
        require(outs[label] == want, f"xh one-shot decompress of {label} "
                "differs from the input")
        print(f"xh one-shot decompress of {label}: {len(want)} bytes equal "
              f"to the input, {stats[label]['batch_decodes']} batch decodes")
    require(native.xh_decompress(spec, len(spec_data))
            == outs["8 MiB (speculative)"],
            "the 8 MiB one-shot decode differs from the native C decoder")
    print("xh one-shot: the 8 MiB decode equal to the native C decoder's")
    require(raised, "a corrupt XH stream did not raise DataError")
    print("xh one-shot corrupt stream: DataError raised")
    for name in path:
        require(launches.get(name, 0) > 0,
                f"{name} never launched on the XH one-shot path")
    print(f"xh one-shot peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    for label, (stream, want) in calls.items():
        reps = 1 if len(want) == len(data) else 5
        ms = cuda_ms(lambda: tpucomp_torch.decompress(
            "xpress_huff", stream, len(want), device="cuda"), reps=reps,
            warmup=0)
        med = statistics.median(ms)
        st = xh.decompress.stats
        print(f"xh one-shot decompress of {label}: median {med:.4f} ms of "
              f"{[round(m, 4) for m in ms]} -> {len(want) / med / 1e6:.4f} "
              f"GB/s; {st['batch_decodes']} batch decodes; host steps of "
              "the last run (s; a phase includes its batch decodes): "
              + "; ".join(f"{k} {v:.4f}" for k, v in st["seconds"].items()))
    profile_device("xh one-shot decompress (8 MiB)",
                   lambda: tpucomp_torch.decompress(
                       "xpress_huff", spec, len(spec_data), device="cuda"))
    return {"fill_records": launches.pop("fill_records_delta2", 0),
            **launches}


def xp_stream_phases(dev, data: bytes, native, kernels, smi: str) -> dict:
    """Phase 15, plain Xpress's single-stream encode.  Adds this path's
    comparisons to the entries of the kernels it runs (as ``shapes``) and
    returns the launches of every kernel on its main path."""
    import torch

    import tpucomp_torch
    from benchmarks.corpus import _synthetic
    from tpucomp_torch.codecs import xpress as xp
    from tpucomp_torch.config import DEFAULT as MATCH
    from tpucomp_torch.kernels import commit, match, runs, sort

    H, cap = xp.WINDOW, xp.stream_lanes(UNIT)
    lanes = -(-len(data) // UNIT)
    vec_data = _synthetic(3 * UNIT + 4321)
    require(hashlib.sha256(vec_data).hexdigest() == XP_STREAM_INPUT_SHA256,
            "the stream vector's input has another sha256")
    with open(os.path.join(ROOT, XP_STREAM_VECTOR), "rb") as f:
        vec = f.read()
    require(hashlib.sha256(vec).hexdigest() == XP_STREAM_SHA256,
            f"{XP_STREAM_VECTOR} has another sha256")
    print(f"xpress stream ({smi}): the corpus, {len(data)} bytes, is {lanes} "
          f"lanes of {UNIT} in dispatches of {cap}; the vector "
          f"{XP_STREAM_VECTOR}, {len(vec)} bytes for {len(vec_data)}")

    # ---- 15. kernel vs plain ------------------------------------------------
    buf = np.frombuffer(data, np.uint8)
    units, ulen, hist0, h0v = xp.stream_rows(buf, 0, cap, UNIT, dev)
    xext = torch.cat([torch.cat([hist0[None], units[:-1, -H:]]), units], 1)
    where = f"Xpress stream [{cap}, {H + UNIT}]"
    got = hold_to_plain(where, "run_matchlens", runs.run_matchlens,
                        runs.run_matchlens_ref, (xext, tuple(MATCH.run_disps)))
    shape_entry(kernels, "run_matchlens", where, got)
    pos_bits = (H + UNIT - 1).bit_length()
    key = match.hash_keys(xext, MATCH.hash_bits, pos_bits)
    err, ms, plain_ms, moved, lib_ms = sort_case(
        where, "sort_rows (hash key, 1 plane)", (key,))
    shape_entry(kernels, "sort_rows", f"{where}, hash key",
                (None, err, ms, plain_ms, moved), library_ms=lib_ms)
    del key
    spos, packed, _ = match.hash_best_match_sorted(
        xext, H + UNIT, MATCH.hash_bits, MATCH.num_candidates, MATCH.cap,
        max_disp=H)
    err, ms, plain_ms, moved, lib_ms = sort_case(
        where, "sort_rows (un-sort, 2 planes)", (spos, packed))
    shape_entry(kernels, "sort_rows", f"{where}, un-sort",
                (None, err, ms, plain_ms, moved), library_ms=lib_ms)
    del spos, packed, xext
    bl, _, use, ok = xp.stream_find_matches(units, ulen, hist0, h0v)
    wwhere = f"Xpress stream walk [{cap}, {UNIT}]"
    got = hold_to_plain(wwhere, "greedy_commit", commit.greedy_commit,
                        commit.greedy_commit_ref, (use, bl, ok),
                        plain_reps=1)
    shape_entry(kernels, "greedy_commit", wwhere, got)
    walk_rounds(wwhere, commit.greedy_commit, UNIT)
    del units, ulen, hist0, bl, use, ok, got

    # ---- 15. main path --------------------------------------------------------
    counters = launch_counters()
    path = ("run_matchlens", "sort_rows", "greedy_commit")
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    vec_out = tpucomp_torch.compress("xpress", vec_data, device="cuda")
    out = tpucomp_torch.compress("xpress", data, device="cuda")
    launches = {fn.__name__: fn.launches for fn in counters if fn.launches}
    peak = torch.cuda.max_memory_allocated()
    print(f"xpress stream main path launches: {launches}")
    require(vec_out == vec, "the card's stream of the vector's input "
            f"differs from {XP_STREAM_VECTOR}")
    print(f"xpress stream: the vector's input encodes to {XP_STREAM_VECTOR} "
          f"(sha256 {XP_STREAM_SHA256})")
    require(native.xpress_decompress(out, len(data)) == data,
            "the corpus's stream does not decode back through the native C "
            "decoder")
    kept = xp.ENCODE_BATCH_CAP
    xp.ENCODE_BATCH_CAP = 8  # dispatches of 8 lanes
    try:
        t0 = time.perf_counter()
        eight = tpucomp_torch.compress("xpress", data, device="cuda")
        eight_s = time.perf_counter() - t0
        n_eight = -(-lanes // xp.stream_lanes(UNIT))
    finally:
        xp.ENCODE_BATCH_CAP = kept
    require(eight == out, "the corpus's stream differs in dispatches of 8 "
            "lanes")
    for name in path:
        require(launches.get(name, 0) > 0,
                f"{name} never launched on the Xpress stream path")
    units_all = [data[i:i + UNIT] for i in range(0, len(data), UNIT)]
    per_unit = sum(map(len, tpucomp_torch.compress_batch(
        "xpress", units_all, device="cuda")))
    ref = native.xpress_compress(data)
    print(f"xpress stream: the corpus encodes to {len(out)} bytes (ratio "
          f"{len(out) / len(data)}), decoding back through the native C "
          f"decoder; equal in {n_eight} dispatches of 8 lanes "
          f"({eight_s:.2f} s); native C one-shot encoder {len(ref)} bytes; "
          f"compress_batch of the {len(units_all)} units of {UNIT} "
          f"{per_unit} bytes (the stream {100 * (1 - len(out) / per_unit):.2f}"
          "% smaller)")
    print(f"xpress stream peak device memory ({smi}): {peak / 2**30:.3f} GiB")

    ms = cuda_ms(lambda: tpucomp_torch.compress("xpress", data,
                                                device="cuda"), reps=5)
    med = statistics.median(ms)
    print(f"xpress stream compress ({smi}): median {med:.4f} ms of "
          f"{[round(m, 4) for m in ms]} -> {len(data) / med / 1e6:.4f} GB/s")
    runs_steps = []
    for _ in range(3):
        steps: dict[str, list[float]] = {}
        got = xp.compress_stream(data, device="cuda",
                                 step=lambda name, fn: clock(steps, name, fn))
        require(got == out, "the stepped stream differs")
        runs_steps.append({k: sum(v) for k, v in steps.items()})
    print(f"xpress stream steps ({smi}), host clock, each synchronised, "
          f"summed over {-(-lanes // cap)} dispatches, median of 3 (ms): "
          + "; ".join(f"{k} {statistics.median(r[k] for r in runs_steps):.4f}"
                      for k in runs_steps[0]))
    profile_device(f"xpress stream compress of the corpus ({smi})",
                   lambda: tpucomp_torch.compress("xpress", data,
                                                  device="cuda"))
    return launches


DIST_FORMATS = (("lznt1", 4096), ("xpress", UNIT), ("xpress_huff", UNIT))
DIST_TWO_RANK_BYTES = 8 << 20  # the corpus prefix of the two-rank run
DIST_REPS = 5
# the entry of each kernel wrapper in the ``kernels`` line
ENTRY_OF = {"fill_records_delta": "fill_records",
            "fill_records_delta2": "fill_records",
            "greedy_commit_layout": "greedy_commit"}
# kernels a trace of an LZNT1 decompress must name
TRACE_KERNELS = ("lznt1_parse_kernel", "fill_records_kernel",
                 "resolve_near_kernel", "far_level_kernel")


def literal_block(n: int = UNIT) -> bytes:
    """``n`` bytes in which no 3-byte string occurs twice (the first ``n``
    of the prefer-largest de Bruijn sequence of order 3 over bytes): every
    encoder writes them as literals.

    tpucomp's native resolved encoders (``xh_compress_opt``,
    ``xpress_compress_opt`` with a depth bound) read the depth state of a
    match's own positions before they write it, so a stream depends on
    the calls before it (ROADMAP queue 3).  A resolved encode of this
    block sets that state to zero at every position of a 64 KiB unit:
    the next call gives the bytes of the port's copy
    (``tpucomp_torch/native/resolved.c``), which zeroes it at every
    call."""
    nxt = [255] * 65536  # the next byte to try after each 2-byte string
    out = bytearray(2)
    while len(out) < n:
        pair = out[-2] << 8 | out[-1]
        require(nxt[pair] >= 0, "no literal block of this length")
        out.append(nxt[pair])
        nxt[pair] -= 1
    return bytes(out[:n])


def sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def gbps(nbytes_: int, ms: list) -> str:
    med = statistics.median(ms)
    return f"{med:.4f} ms ({nbytes_ / med / 1e6:.4f} GB/s)"


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_worker(rank: int, port: int, path: str) -> None:
    """One rank of phase 16's two-rank gloo group, on
    ``cuda:{LOCAL_RANK % the visible devices}`` (``cuda:0`` on one card):
    ``ShardedCodec`` of the bytes in ``path`` in each format, decoded
    back, then compress and decompress timed ``DIST_REPS`` times after
    that warm-up, both ranks starting each call at a barrier.  Prints one
    ``DIST_WORKER`` line of JSON: the archives' sha256 and the times."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from tpucomp_torch.dist import ShardedCodec, data_mesh

    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=timedelta(seconds=300))
    try:
        mesh = data_mesh()
        require((mesh.world_size, mesh.backend) == (2, "gloo"),
                f"rank {rank}: not a two-rank gloo group")
        with open(path, "rb") as f:
            data = f.read()
        got = {"device": str(mesh.device)}

        def wall(fn) -> float:
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        for fmt, _ in DIST_FORMATS:
            sc = ShardedCodec(fmt, mesh=mesh)
            arch = sc.compress(data)
            require(sc.decompress(arch) == data,
                    f"rank {rank}: {fmt} two-rank archive does not decode")
            got[fmt] = sha256(arch.to_bytes())
            got[f"{fmt} compress ms"] = [
                wall(lambda: sc.compress(data)) for _ in range(DIST_REPS)]
            got[f"{fmt} decompress ms"] = [
                wall(lambda: sc.decompress(arch)) for _ in range(DIST_REPS)]
        print("DIST_WORKER " + json.dumps(got), flush=True)
    finally:
        dist.destroy_process_group()


def two_ranks(data: bytes, want: dict) -> None:
    """Phase 16's two ranks on the one card: two worker processes of this
    script (:func:`dist_worker`) in a gloo group, each on cuda:0; their
    archives' sha256 must equal the one-rank ``want``.  Their times are
    printed beside one rank's (no group, this process) on the same
    bytes."""
    import tempfile

    import torch

    from tpucomp_torch.dist import ShardedCodec, data_mesh

    one = {}
    for fmt, _ in DIST_FORMATS:
        sc = ShardedCodec(fmt, mesh=data_mesh())
        arch = sc.compress(data)
        sc.decompress(arch)
        for call, fn in (("compress", lambda: sc.compress(data)),
                         ("decompress", lambda: sc.decompress(arch))):
            one[fmt, call] = []
            for _ in range(DIST_REPS):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                one[fmt, call].append((time.perf_counter() - t0) * 1e3)

    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "data.bin")
    with open(path, "wb") as f:
        f.write(data)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-worker",
         str(rank), str(port), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(tmp)
    wall_s = time.perf_counter() - t0
    got = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        require(p.returncode == 0,
                f"two-rank worker {rank} failed:\n{out[-4000:]}")
        line = next(l for l in out.splitlines()
                    if l.startswith("DIST_WORKER "))
        got.append(json.loads(line[len("DIST_WORKER "):]))
    for rank, g in enumerate(got):
        require(g["device"] == "cuda:0", f"rank {rank} ran on {g['device']}")
        for fmt, _ in DIST_FORMATS:
            require(g[fmt] == want[fmt], f"rank {rank}'s {fmt} archive "
                    "differs from the one-rank archive")
    print(f"two ranks (gloo, both on cuda:0), {len(data)} bytes: every "
          f"archive equal to the one-rank archive by sha256 on both ranks; "
          f"the two worker processes {wall_s:.2f} s from start to exit")
    for fmt, _ in DIST_FORMATS:
        for call in ("compress", "decompress"):
            ms = got[0][f"{fmt} {call} ms"]
            solo = statistics.median(one[fmt, call])
            print(f"  two ranks {fmt} ShardedCodec.{call}, rank 0, median of "
                  f"{DIST_REPS} after a warm-up: {gbps(len(data), ms)}; runs "
                  f"{[round(m, 4) for m in ms]}; rank 1 median "
                  f"{statistics.median(got[1][f'{fmt} {call} ms']):.4f} ms; "
                  f"one rank {solo:.4f} ms (x{statistics.median(ms) / solo:.3f}"
                  ")")


def one_rank_nccl(data: bytes, want: dict) -> None:
    """A one-rank NCCL group in this process: ``ShardedCodec`` round trips
    of ``data`` in each format through the all-gather on the card, equal
    to the archives ``want`` made with no group."""
    import torch.distributed as dist

    from tpucomp_torch.dist import ShardedCodec, data_mesh

    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    gathers = []
    real = dist.all_gather
    dist.all_gather = lambda out, t, **kw: (gathers.append(t.device),
                                            real(out, t, **kw))[1]
    try:
        mesh = data_mesh()
        require(mesh.backend == "nccl", f"backend {mesh.backend}")
        for fmt, _ in DIST_FORMATS:
            sc = ShardedCodec(fmt, mesh=mesh)
            arch = sc.compress(data)
            require(sha256(arch.to_bytes()) == want[fmt],
                    f"{fmt}: the one-rank NCCL archive differs")
            require(sc.decompress(arch) == data,
                    f"{fmt}: the one-rank NCCL archive does not decode")
    finally:
        dist.all_gather = real
        dist.destroy_process_group()
    require(len(gathers) == 4 * len(DIST_FORMATS)
            and all(d.type == "cuda" for d in gathers),
            f"the NCCL group's all-gathers: {gathers}")
    print(f"one-rank NCCL group on {mesh.device}: {len(gathers)} all-gathers "
          "of device tensors; every archive equal to the one-rank archive, "
          "each decoding back")


def trace_kernels(data: bytes, when: str) -> None:
    """Phase 16's trace: ``data`` through LZNT1's ``ShardedCodec`` with one
    rank, then one ``decompress`` with ``trace_dir``, whose one trace file
    must name the LZNT1 decode's kernels (``TRACE_KERNELS``) with no
    ``device_trace`` warning of a kernel launch without a device record.
    Taken before phase 3 and again at the end of phase 16 (``when``): a
    profiler session in a process that has run for minutes loses its
    first device records, which ``device_trace``'s primer takes
    (``tpucomp_torch.stats``; without it, the trace at phase 16 held no
    device record in runs 18A and 18B)."""
    import collections
    import tempfile
    import warnings

    from tpucomp_torch import stats
    from tpucomp_torch.dist import ShardedCodec, data_mesh

    archive = ShardedCodec("lznt1", mesh=data_mesh()).compress(data)
    logdir = tempfile.mkdtemp()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ShardedCodec("lznt1", mesh=data_mesh(),
                         trace_dir=logdir).decompress(archive)
        (name,) = os.listdir(logdir)
        with open(os.path.join(logdir, name)) as f:
            trace = f.read()
    finally:
        shutil.rmtree(logdir)
    events = json.loads(trace)["traceEvents"]
    (primer,) = [e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") == stats.PRIMER]
    after = [e for e in events if e.get("cat") == "kernel"
             and e["ts"] >= primer["ts"] + primer["dur"]]
    lost = [str(w.message) for w in caught
            if str(w.message).startswith("device_trace")]
    missing = [k for k in TRACE_KERNELS
               if not any(k in e["name"] for e in after)]
    if missing or lost:
        print("trace events by category: " + str(dict(collections.Counter(
            e.get("cat") for e in events))) + f"; {lost}")
    require(not missing, f"the trace {when} names none of {missing}")
    require(not lost, f"the trace {when} lost device records: {lost}")
    print(f"trace_dir {when}: one trace of an LZNT1 ShardedCodec.decompress "
          f"of {len(data)} bytes, {len(trace)} bytes, "
          f"{len(after)} kernel records after the primer, naming "
          f"{', '.join(TRACE_KERNELS)}; every launch has its device record")


def dist_split(fmt: str, sc, data: bytes, archive) -> None:
    """Where one rank's ``ShardedCodec`` call spends its time beside the
    batch call it makes, on the host clock, median of ``DIST_REPS``
    (the card synchronised around each step): ``compress`` as the batch
    call (``_compress_units``), the unit split (the same slicing, timed
    alone) and the rest (the manifest and the payload); ``decompress``
    as the batch call (``_decompress_units``), ``unit_streams`` and the
    join (each timed alone) and the rest."""
    import torch

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    u = sc.unit_size
    inner = []

    def spy(real):
        def call(*args, **kw):
            ms, out = wall(lambda: real(*args, **kw))
            inner.append((ms, out))
            return out
        return call

    ms = {}
    for call, name, run in (
            ("compress", "_compress_units", lambda: sc.compress(data)),
            ("decompress", "_decompress_units",
             lambda: sc.decompress(archive))):
        setattr(sc, name, spy(getattr(sc, name)))
        try:
            for _ in range(DIST_REPS):
                inner.clear()
                whole = wall(run)[0]
                (batch, out), = inner
                if call == "compress":
                    alone = {"the unit split": wall(lambda: [
                        data[i:i + u] for i in range(0, len(data), u)])[0]}
                else:
                    alone = {"unit_streams": wall(archive.unit_streams)[0],
                             "the join": wall(lambda: b"".join(out))[0]}
                steps = {"whole": whole, "the batch call": batch, **alone,
                         "the rest": whole - batch - sum(alone.values())}
                for k, v in steps.items():
                    ms.setdefault((call, k), []).append(v)
        finally:
            delattr(sc, name)
        print(f"  {fmt} ShardedCodec.{call}, one rank, host clock, median "
              f"of {DIST_REPS} (ms): " + "; ".join(
                  f"{k} {statistics.median(v):.4f}"
                  for (c, k), v in ms.items() if c == call))


def dist_phases(data: bytes, native, kernels, smi: str) -> dict:
    """Phase 16, the dist layer.  Returns the launches of every kernel on
    its main path, by ``kernels`` entry."""
    import tpucomp_torch
    from tpucomp_torch.dist import (Archive, MixedBatch, ShardedCodec,
                                    ShardedLZNT1, data_mesh)

    mesh = data_mesh()
    require((mesh.world_size, mesh.backend) == (1, None),
            "phase 16 runs with no process group first")
    # ---- 16. what the sharded path is held to, made before its launches
    # are counted: compress_batch of the same units, the native C build's
    # resolved streams (each unit from a zeroed depth state, as the port's
    # copy starts every call: literal_block), ShardedCodec of each
    # MixedBatch job, and compress of the corpus
    units_of, want_streams, want_resolved = {}, {}, {}
    for fmt, u in DIST_FORMATS:
        units_of[fmt] = [data[i:i + u] for i in range(0, len(data), u)]
        want_streams[fmt] = tpucomp_torch.compress_batch(
            fmt, units_of[fmt], device="cuda")
    flags = Native.OPT_RESOLVE_OFFSETS | 2 << 8
    zeros = literal_block()
    for fmt, _ in DIST_FORMATS[1:]:
        opt = (native.xh_compress_opt if fmt == "xpress_huff"
               else native.xpress_compress_opt)
        want_resolved[fmt] = [(opt(zeros, flags), opt(x, flags))[1]
                              for x in units_of[fmt]]
    M = 8 << 20
    jobs = [("lznt1", data[:M]), ("xpress_huff", data[M:2 * M + 12345]),
            ("xpress", data[2 * M + 12345:3 * M]), ("lznt1", data[3 * M:]),
            ("xpress_huff", data[:5000])]
    want_mixed = [ShardedCodec(fmt, mesh=mesh).compress(d).to_bytes()
                  for fmt, d in jobs]
    want_lznt1 = tpucomp_torch.compress("lznt1", data, device="cuda")

    # ---- 16. one rank, the corpus in each format: the sharded path alone
    # from here to the launch counts below
    counters = launch_counters()
    for fn in counters:
        fn.launches = 0
    archives = {}
    for fmt, u in DIST_FORMATS:
        units = units_of[fmt]
        sc = ShardedCodec(fmt, mesh=mesh)
        t0 = time.perf_counter()
        arch = sc.compress(data)
        enc_s = time.perf_counter() - t0
        require(arch.unit_streams() == want_streams[fmt],
                f"{fmt}: the archive's unit streams differ from compress_batch")
        raw = arch.to_bytes()
        back = Archive.from_bytes(raw)
        require(back.to_bytes() == raw and back.manifest == arch.manifest,
                f"{fmt}: to_bytes / from_bytes does not round-trip")
        require(sc.decompress(back) == data, f"{fmt}: decompress differs")
        if fmt == "lznt1":
            require(native.lznt1_decompress(arch.payload, len(data)) == data,
                    "the LZNT1 archive's payload does not decode as one "
                    "stream through the native C decoder")
        half = len(units) // 2
        resumed = sc.compress(data, resume=sc.compress(data[:half * u]))
        require(resumed.to_bytes() == raw,
                f"{fmt}: the archive resumed at unit {half} differs")
        archives[fmt] = (sc, back, units)
        print(f"sharded {fmt}, one rank ({smi}): {len(units)} units of {u}, "
              f"archive {len(raw)} bytes ({sc.last_stats.ratio:.6f} of the "
              f"input), {enc_s:.2f} s the first compress; unit streams equal "
              "to compress_batch; from_bytes round-trips; decompress equal "
              f"to the corpus; resumed at unit {half} equal"
              + ("; the payload decodes through the native C decoder"
                 if fmt == "lznt1" else ""))
    # resolved archives by the port's own encoder, depth 2
    probes0 = next(f for f in counters if f.__name__ == "far_probe").launches
    for fmt, u in DIST_FORMATS[1:]:
        sc = ShardedCodec(fmt, mesh=mesh, resolve_offsets=True)
        t0 = time.perf_counter()
        arch = sc.compress(data)
        enc_s = time.perf_counter() - t0
        require(arch.manifest.resolved
                and arch.unit_streams() == want_resolved[fmt],
                f"{fmt}: the resolved archive differs from the native build's")
        require(sc.decompress(Archive.from_bytes(arch.to_bytes())) == data,
                f"{fmt}: the resolved archive does not decode")
        print(f"sharded {fmt} resolved (depth 2): {len(arch.payload)} bytes, "
              f"{enc_s:.2f} s to encode, equal to the native C build's "
              "streams (each unit from a zeroed depth state), decoding back")
    probes = next(f for f in counters if f.__name__ == "far_probe").launches
    require(probes > probes0, "far_probe never launched on the resolved "
            "archives")
    # MixedBatch and ShardedLZNT1
    mb = MixedBatch(mesh=mesh)
    mixed = mb.compress(jobs)
    require([a.to_bytes() for a in mixed] == want_mixed,
            "a MixedBatch archive differs from ShardedCodec's")
    require(mb.decompress(mixed) == [d for _, d in jobs],
            "MixedBatch.decompress differs from the jobs")
    sl = ShardedLZNT1(mesh)
    stream = sl.compress(data)
    require(stream == want_lznt1, "ShardedLZNT1.compress differs from compress")
    require(sl.decompress(stream) == data, "ShardedLZNT1.decompress differs")
    require(sl.decompress(stream, 100000) == data[:100000],
            "ShardedLZNT1.decompress ignores out_len")
    try:
        sl.decompress(stream[:-1])
        raised = False
    except tpucomp_torch.DataError:
        raised = True
    require(raised, "a short LZNT1 stream did not raise DataError")
    print(f"MixedBatch of {len(jobs)} jobs (LZNT1, XH, Xpress interleaved): "
          "each archive equal to ShardedCodec's, decompress equal to the "
          "jobs; ShardedLZNT1: equal to compress, decoding back, out_len "
          "kept, a short stream raising DataError")
    launches = {}
    for fn in counters:
        name = ENTRY_OF.get(fn.__name__, fn.__name__)
        launches[name] = launches.get(name, 0) + fn.launches
    print(f"sharded main path launches: {launches}")
    for k in kernels:
        require(launches.get(k["name"], 0) > 0,
                f"{k['name']} never launched on the sharded path")

    # ---- 16. NCCL in one rank, and two ranks on the one card ----------------
    head = data[:DIST_TWO_RANK_BYTES]
    want = {fmt: sha256(ShardedCodec(fmt, mesh=mesh).compress(
        head).to_bytes()) for fmt, _ in DIST_FORMATS}
    one_rank_nccl(head, want)
    two_ranks(head, want)

    # ---- 16. figures: the layer beside the batch calls, in turns -------------
    for fmt, u in DIST_FORMATS:
        sc, back, units = archives[fmt]
        streams = back.unit_streams()
        lens = back.manifest.unit_out_lens
        calls = {
            "ShardedCodec.compress": lambda: sc.compress(data),
            "compress_batch": lambda: tpucomp_torch.compress_batch(
                fmt, units, device="cuda"),
            "ShardedCodec.decompress": lambda: sc.decompress(back),
            "decompress_batch": lambda: tpucomp_torch.decompress_batch(
                fmt, streams, lens, device="cuda")}
        times = {label: [] for label in calls}
        for fn in calls.values():
            fn()  # warm-up
        for _ in range(DIST_REPS):
            for label, fn in calls.items():
                times[label] += cuda_ms(fn, reps=1, warmup=0)
        for label, ms in times.items():
            print(f"sharded {fmt} ({smi}) {label}, one rank, median of "
                  f"{DIST_REPS} in turns after a warm-up: "
                  f"{gbps(len(data), ms)}; runs {[round(m, 4) for m in ms]}")
        for call, batch in (("compress", "compress_batch"),
                            ("decompress", "decompress_batch")):
            diff = (statistics.median(times[f"ShardedCodec.{call}"])
                    - statistics.median(times[batch]))
            print(f"  the dist layer's own cost, {fmt} {call}: {diff:.4f} ms "
                  f"over {batch}")
        dist_split(fmt, sc, data, back)
    trace_kernels(data[:DIST_TWO_RANK_BYTES], "at the end of phase 16")
    return launches


STREAM_BYTES = 8 << 20  # the corpus prefix of the streaming phase
STREAM_MAX_FEED = 256 << 10
STREAM_UNITS = 16  # corpus units through decompress_unit, each format
ORACLE_BYTES = 64 << 10
ORACLE_MAX_FEED = 16 << 10
STREAM_REPS = 3
# the kernels of the LZNT1 streams (rows 1-3, 5 and 8-10 of PERF.md's
# table) and of the unit-framed Xpress and XH decodes
STREAM_LZNT1 = ("lznt1_parse", "resolve_near", "far_level", "fill_records",
                "run_matchlens", "sort_rows", "greedy_commit")
STREAM_UNIT = ("xh_parse", "xp_parse", "fill_records", "resolve_near",
               "far_level", "far_row")


def ragged_feeds(data: bytes, rng, hi: int) -> list:
    """``data`` cut into feeds of 1 to ``hi`` bytes, their sizes drawn
    log-uniformly from ``rng`` (most feeds short, most bytes in long
    ones)."""
    feeds, i = [], 0
    while i < len(data):
        n = int(np.exp(rng.uniform(0.0, np.log(hi + 1))))
        feeds.append(data[i:i + max(1, min(n, hi))])
        i += len(feeds[-1])
    return feeds


def streamed(obj, method: str, feeds: list) -> bytes:
    return b"".join(getattr(obj, method)(f) for f in feeds) + obj.flush()


def stream_phases(data: bytes, native, smi: str) -> dict:
    """Phase 17, the streaming API.  Returns the launches of every kernel
    on its main path, by ``kernels`` entry."""
    import tpucomp_torch

    rng = np.random.default_rng(SEED + 17)
    head = data[:STREAM_BYTES]
    enc_feeds = ragged_feeds(head, rng, STREAM_MAX_FEED)
    # ---- 17. what the streams are held to, made before the counts are set
    # to 0: the one-shot device encode, the units' native streams
    want_enc = tpucomp_torch.compress("lznt1", head, device="cuda")
    units = [data[i * UNIT:(i + 1) * UNIT] for i in range(STREAM_UNITS)]
    unit_streams = {"xpress": [native.xpress_compress(u) for u in units],
                    "xpress_huff": [native.xh_compress(u) for u in units]}

    # ---- 17. the streaming main path on the card, counts from 0
    counters = launch_counters()
    for fn in counters:
        fn.launches = 0
    enc = streamed(tpucomp_torch.Compressor("lznt1"), "compress", enc_feeds)
    dec_feeds = ragged_feeds(enc, rng, STREAM_MAX_FEED)
    dec = streamed(tpucomp_torch.Decompressor("lznt1"), "decompress",
                   dec_feeds)
    unit_out = {}
    for fmt, streams in unit_streams.items():
        d = tpucomp_torch.Decompressor(
            fmt, unit_out_lens=[len(u) for u in units])
        unit_out[fmt] = [d.decompress_unit(s) for s in streams]
    launches = {}
    for fn in counters:
        name = ENTRY_OF.get(fn.__name__, fn.__name__)
        launches[name] = launches.get(name, 0) + fn.launches
    print(f"streaming main path launches: {launches}")
    require(enc == want_enc, "the LZNT1 Compressor's stream differs from "
            "one-shot compress on the card")
    require(native.lznt1_decompress(enc, len(head)) == head,
            "the LZNT1 Compressor's stream does not decode through the "
            "native C decoder")
    require(dec == head, "the LZNT1 Decompressor's output differs from the "
            "input")
    for fmt, out in unit_out.items():
        require(out == units, f"{fmt} decompress_unit differs from the units")
    for name in STREAM_LZNT1 + STREAM_UNIT:
        require(launches.get(name, 0) > 0,
                f"{name} never launched on the streaming path")
    print(f"streaming LZNT1 on the card: {len(head)} bytes in "
          f"{len(enc_feeds)} feeds "
          f"of 1 to {STREAM_MAX_FEED} bytes ({launches['greedy_commit']} "
          f"encode batches), equal to one-shot compress and decoding back "
          f"through the native C decoder; its {len(enc)} bytes in "
          f"{len(dec_feeds)} feeds ({launches['lznt1_parse']} decode "
          f"batches) through Decompressor equal to the input; "
          f"decompress_unit of {STREAM_UNITS} corpus units of {UNIT} in "
          "Xpress and XH equal to them")

    # ---- 17. figures: each direction fed beside one-shot, in turns
    calls = {
        "Compressor, fed": lambda: streamed(
            tpucomp_torch.Compressor("lznt1"), "compress", enc_feeds),
        "compress, one-shot": lambda: tpucomp_torch.compress(
            "lznt1", head, device="cuda"),
        "Decompressor, fed": lambda: streamed(
            tpucomp_torch.Decompressor("lznt1"), "decompress", dec_feeds),
        "decompress, one-shot": lambda: tpucomp_torch.decompress(
            "lznt1", enc, device="cuda"),
    }
    times = {label: [] for label in calls}
    for fn in calls.values():
        fn()  # warm-up
    for _ in range(STREAM_REPS):
        for label, fn in calls.items():
            times[label] += cuda_ms(fn, reps=1, warmup=0)
    for label, ms in times.items():
        print(f"streaming lznt1 ({smi}) {label}, median of {STREAM_REPS} in "
              f"turns after a warm-up: {gbps(len(head), ms)}; runs "
              f"{[round(m, 4) for m in ms]}")
    for fed, one, calls_ in (("Compressor, fed", "compress, one-shot",
                              launches["greedy_commit"]),
                             ("Decompressor, fed", "decompress, one-shot",
                              launches["lznt1_parse"])):
        diff = (statistics.median(times[fed])
                - statistics.median(times[one]))
        print(f"  the cost of feeding ({smi}), {fed} over {one}: "
              f"{diff:.4f} ms, {diff / calls_:.4f} ms a device call "
              f"({calls_} calls)")
    profile_device(f"streaming LZNT1 Decompressor, fed ({smi})",
                   calls["Decompressor, fed"])

    # ---- 17. backend="cpu": the port's copy of the native codec
    for fmt, comp, decomp in (
            ("lznt1", native.lznt1_compress, native.lznt1_decompress),
            ("xpress", native.xpress_compress, native.xpress_decompress),
            ("xpress_huff", native.xh_compress, native.xh_decompress)):
        ref = comp(head)
        one = tpucomp_torch.compress(fmt, head, backend="cpu")
        require(one == ref, f"{fmt}: the port's native one-shot encode "
                "differs from the reference build's")
        require(tpucomp_torch.decompress(fmt, one, len(head), backend="cpu")
                == decomp(one, len(head)) == head,
                f"{fmt}: the port's native one-shot decode differs")
        feeds = ragged_feeds(head, rng, STREAM_MAX_FEED)
        t0 = time.perf_counter()
        s = streamed(tpucomp_torch.Compressor(fmt, backend="cpu"),
                     "compress", feeds)
        enc_ms = (time.perf_counter() - t0) * 1e3
        note = "equal to the native one-shot (the port's and the reference "
        note += "build's)"
        if s != one:
            at = next(i for i, (a, b) in enumerate(zip(s, one)) if a != b)
            require(fmt == "xpress", f"{fmt}: the cpu Compressor's stream "
                    "differs from the native one-shot")
            note = (f"DIFFERS from the native one-shot from byte {at} (a "
                    "match deferred past 1 MiB is emitted early)")
        out_len = len(head) if fmt != "lznt1" else None
        t0 = time.perf_counter()
        back = streamed(tpucomp_torch.Decompressor(fmt, backend="cpu",
                                                   out_len=out_len),
                        "decompress", ragged_feeds(s, rng, STREAM_MAX_FEED))
        dec_ms = (time.perf_counter() - t0) * 1e3
        require(back == head, f"{fmt}: the cpu Decompressor does not decode "
                "back")
        print(f"streaming {fmt} backend=cpu ({smi}, the host): {len(feeds)} "
              f"feeds, {len(s)} bytes, {note}; decoding back; Compressor "
              f"{enc_ms:.4f} ms ({len(head) / enc_ms / 1e3:.4f} MB/s), "
              f"Decompressor {dec_ms:.4f} ms ({len(head) / dec_ms / 1e3:.4f} "
              "MB/s), the host clock, one run")

    # ---- 17. backend="oracle": the port's copy of the spec codecs
    small = head[:ORACLE_BYTES]
    for fmt, opts in (("lznt1", {}), ("xpress", {}),
                      ("xpress_huff", {"cross_block": True})):
        want = tpucomp_torch.compress(fmt, small, backend="oracle", **opts)
        t0 = time.perf_counter()
        s = streamed(tpucomp_torch.Compressor(fmt, backend="oracle"),
                     "compress", ragged_feeds(small, rng, ORACLE_MAX_FEED))
        out_len = len(small) if fmt != "lznt1" else None
        back = streamed(tpucomp_torch.Decompressor(fmt, backend="oracle",
                                                   out_len=out_len),
                        "decompress", ragged_feeds(s, rng, ORACLE_MAX_FEED))
        oracle_s = time.perf_counter() - t0
        require(s == want, f"{fmt}: the oracle Compressor's stream differs "
                "from the oracle's one-shot")
        require(back == small, f"{fmt}: the oracle Decompressor does not "
                "decode back")
        print(f"streaming {fmt} backend=oracle: {len(small)} bytes in ragged "
              f"feeds equal to the oracle's one-shot"
              + (" (cross_block=True)" if fmt == "xpress_huff" else "")
              + f", decoding back; {oracle_s:.2f} s on the host")
    return launches


FUZZ_LZNT1_BATCHES = 2  # each the corpus's chunks, every one mutated once
FUZZ_UNIT_BATCHES = 19  # Xpress and XH: 19 x 546 = 10,374 mutants a format
FUZZ_ROWS = 546  # rows of an Xpress or XH batch, as phases 5 and 9
FUZZ_RESOLVED = 3  # of the XH batches: resolved streams, fast_resolve
FUZZ_ONESHOT = 64  # mutants of the 10-block XH stream through decompress
FUZZ_SUB_ROWS = 32  # rows of the parses' plain sub-batch: the shortest
FUZZ_SUB_BODY = 4096  # ... whose stream is at most this long
FUZZ_MIN = 10_000  # mutants a format, at the least
# the decode kernels phase 18 must launch
FUZZ_KERNELS = ("lznt1_parse", "xp_parse", "xh_parse", "fill_records",
                "resolve_near", "far_level", "far_probe", "far_row")


def load_mutator():
    """``tests/_mutate.py`` (numpy only), loaded by path."""
    import importlib.util

    path = os.path.join(ROOT, "tests", "_mutate.py")
    spec = importlib.util.spec_from_file_location("_mutate", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def host_outcome(fn, *args):
    """("ok", bytes) or (the exception class's name,)."""
    try:
        return ("ok", bytes(fn(*args)))
    except Exception as e:  # noqa: BLE001 - the class is the outcome
        return (type(e).__name__,)


class FuzzTally:
    """Phase 18's counts of one format: mutants, each side's rejects, the
    classes of the disagreements (``_mutate.classify``)."""

    def __init__(self, M, fmt):
        self.M, self.fmt = M, fmt
        self.n = self.dev_rej = self.nat_rej = 0
        self.classes: dict = {}
        self.unlisted: list = []

    def add(self, m, dev, nat, unit_size=None):
        self.n += 1
        self.dev_rej += dev[0] != "ok"
        self.nat_rej += nat[0] != "ok"
        out_len = None if self.fmt == "lznt1" else m.out_len
        for c in self.M.classify(self.fmt, m.stream, out_len,
                                 {"device": dev, "native": nat}, unit_size):
            self.classes[c] = self.classes.get(c, 0) + 1
            if c == self.M.UNLISTED:
                self.unlisted.append((m.seed, m.index, m.op))

    def line(self, label) -> str:
        return (f"{label}: {self.n} mutants; rejected by the device path "
                f"{self.dev_rej}, by the native C decoder {self.nat_rej}; "
                f"disagreements by class {self.classes or 'none'}")


def fuzz_lznt1(M, dev, stream, tally):
    """The LZNT1 batches: every chunk of the corpus's stream mutated once
    a batch (a chunk is a one-chunk stream, its own source), split into
    its rows, one ``decode_batch`` a batch on the card, each mutant's
    rows against the native C decoder.  Returns the kept batches."""
    from tpucomp_torch import _native
    from tpucomp_torch.codecs import lznt1 as lz

    spans = chunk_spans(stream)
    sources = [(stream[a:b], 0) for a, b in spans]
    ops = M.OPERATORS["lznt1"]
    kept = []
    for b in range(FUZZ_LZNT1_BATCHES):
        muts = [M.mutant("lznt1", sources, SEED + 18 + b, k,
                         ops[(k + b) % len(ops)], source=k)
                for k in range(len(sources))]
        rows, owner, split = [], [], []
        for i, m in enumerate(muts):
            try:
                pls, cps = lz.split_stream(m.stream)
            except Exception as e:  # noqa: BLE001 - the class is the outcome
                split.append((type(e).__name__,))
                continue
            split.append(None)
            rows += list(zip(pls, cps))
            owner += [i] * len(pls)
        batch = lz.pack_chunks([p for p, _ in rows], [c for _, c in rows],
                               dev)
        out, out_len, err = lz.decode_batch(*batch)
        out, out_len, err = (t.cpu().numpy() for t in (out, out_len, err))
        parts: dict = {}
        for k, i in enumerate(owner):
            parts.setdefault(i, []).append(k)
        for i, m in enumerate(muts):
            ks = parts.get(i, [])
            d = split[i] or (("DataError",) if any(err[k] for k in ks) else
                             ("ok", b"".join(out[k, :out_len[k]].tobytes()
                                             for k in ks)))
            tally.add(m, d, host_outcome(_native.lznt1_decompress, m.stream,
                                         None))
        kept.append(batch)
        print(f"fuzz lznt1 batch {b}: {len(muts)} mutants in "
              f"{batch[0].shape[0]} rows of {batch[0].shape[1]}")
    return kept


def fuzz_units(M, fmt, dev, tally, sources, batches, fast=False):
    """Xpress or XH batches of ``FUZZ_ROWS`` mutants of 64 KiB unit
    streams: one ``decode_batch`` a batch on the card, each row's
    accept/reject and bytes against the native C decoder.  A stream
    longer than a unit's largest encoding goes through
    ``decompress_units`` (which raises DataError before any launch).
    Returns the kept batches' inputs."""
    from tpucomp_torch import _native
    from tpucomp_torch.codecs import xpress as xp
    from tpucomp_torch.codecs import xpress_huff as xh

    mod = xh if fmt == "xpress_huff" else xp
    native_dec = (_native.xh_decompress if fmt == "xpress_huff"
                  else _native.xpress_decompress)
    ops = M.OPERATORS[fmt]
    kept = []
    for b in batches:
        muts = [M.mutant(fmt, sources, SEED + 180 + b, k, ops[k % len(ops)],
                         out_cap=UNIT) for k in range(FUZZ_ROWS)]
        rows = [m for m in muts if len(m.stream) <= mod.max_payload(UNIT)]
        batch = mod.pack_units([m.stream for m in rows],
                               [m.out_len for m in rows], UNIT, dev)
        if fmt == "xpress_huff":
            out, err = mod.decode_batch(*batch, UNIT, fast_resolve=fast)
        else:
            out, err = mod.decode_batch(*batch, UNIT)
        out, err = out.cpu().numpy(), err.cpu().numpy()
        k = 0
        for m in muts:
            if len(m.stream) > mod.max_payload(UNIT):
                d = host_outcome(lambda s, n: mod.decompress_units(
                    [s], [n], UNIT, device=dev)[0], m.stream, m.out_len)
            else:
                d = (("DataError",) if err[k] else
                     ("ok", out[k, :m.out_len].tobytes()))
                k += 1
            tally.add(m, d, host_outcome(native_dec, m.stream, m.out_len),
                      UNIT)
        kept.append(batch)
    return kept


def fuzz_shortest(plen, n=FUZZ_SUB_ROWS):
    """Indices of up to ``n`` rows with the shortest streams, of at most
    ``FUZZ_SUB_BODY`` bytes: the parses' plain versions loop once per
    byte."""
    import torch

    order = torch.argsort(plen)
    idx = order[plen[order] <= FUZZ_SUB_BODY][:n]
    require(len(idx) > 0, "no short row for the plain parse")
    return idx


def hold(errs, name, label, fn, ref, args):
    """Kernel wrapper ``fn`` against its plain version ``ref`` on
    ``args``, exactly; its max abs error kept in ``errs[name]``.  Returns
    the kernel's output."""
    got = fn(*args)
    errs[name] = max(errs.get(name, 0),
                     compare(f"{name} (fuzz, {label})", got, ref(*args)))
    return got


def hold_parse(errs, name, label, fn, ref, parsed, sub, sub_args):
    """A parse's plain version on the rows ``sub`` of a batch, against
    the kernel on those rows alone and against the rows of the whole
    batch's launch ``parsed``, exactly."""
    want = ref(*sub_args)
    errs[name] = max(
        errs.get(name, 0),
        compare(f"{name} (fuzz, {label}, the shortest rows)",
                fn(*sub_args), want),
        compare(f"{name} (fuzz, {label}, the whole batch's rows)",
                tuple(p[sub] for p in parsed), want))


def hold_tail(errs, label, rec_pos, rec_val, keep, fast):
    """Xpress's and XH's decode tail on a batch's records, each kernel
    against its plain version on the kernel's own inputs: the fill of
    both planes, the near walk, the 4 KiB level, the probes (``fast``),
    the row level."""
    from tpucomp_torch.codecs import xpress_huff as xh
    from tpucomp_torch.kernels import fill, gather, resolve
    from tpucomp_torch.kernels.common import (ARCHIVE_PROBE_BUDGET,
                                              SEG_LEVEL, SEG_LEVEL_CAP)

    got = hold(errs, "fill_records", label, fill.fill_records_delta2,
               fill.fill_records_delta2_ref, (rec_pos, rec_val, UNIT, keep))
    out = hold(errs, "resolve_near", label, resolve.resolve_near,
               resolve.resolve_near_ref, xh.near_inputs(got[0], got[1]))
    out = hold(errs, "far_level", label, gather.far_level,
               gather.far_level_ref, (out, SEG_LEVEL, SEG_LEVEL_CAP, False))
    if fast:
        out = hold(errs, "far_probe", label, gather.far_probe,
                   gather.far_probe_ref, (out, ARCHIVE_PROBE_BUDGET))
    hold(errs, "far_row", label, gather.far_row, gather.far_row_ref, (out,))


def fuzz_phases(dev, data, stream, units, smi) -> tuple:
    """Phase 18, the decoders on mutated streams.  Returns the launches
    of every kernel on its main path (the decodes of the mutants) and
    each decode kernel's max abs error against its plain version."""
    import torch

    from tpucomp_torch import _native
    from tpucomp_torch.codecs import lznt1 as lz
    from tpucomp_torch.codecs import xpress as xp
    from tpucomp_torch.codecs import xpress_huff as xh
    from tpucomp_torch.kernels import (fill, gather, lznt1_parse, resolve,
                                       xh_parse, xp_parse)

    started = time.perf_counter()
    M = load_mutator()
    rng = np.random.default_rng(SEED + 18)
    units = xh_units(units, rng)
    xp_sources = [(_native.xpress_compress(u), len(u)) for u in units]
    xh_sources = [(_native.xh_compress(u), len(u)) for u in units]
    resolved = [(_native.xh_compress_resolved(u, max_depth=2), len(u))
                for u in units]
    ten = data[:XH_TEN_BLOCKS]
    ten_src = [(_native.xh_compress(ten), len(ten))]
    print(f"fuzz sources: {len(chunk_spans(stream))} LZNT1 chunks, "
          f"{len(units)} Xpress, XH and resolved XH units of {UNIT} bytes, "
          f"the {len(ten)}-byte 10-block XH stream; "
          f"{time.perf_counter() - started:.2f} s")

    # ---- 18. the main path: every mutant through the decoders, counts from 0
    tallies = {f: FuzzTally(M, f) for f in ("lznt1", "xpress", "xpress_huff")}
    oneshot = FuzzTally(M, "xpress_huff")
    counters = launch_counters()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    lz_kept = fuzz_lznt1(M, dev, stream, tallies["lznt1"])
    xp_kept = fuzz_units(M, "xpress", dev, tallies["xpress"], xp_sources,
                         range(FUZZ_UNIT_BATCHES))
    n_plain = FUZZ_UNIT_BATCHES - FUZZ_RESOLVED
    xh_kept = fuzz_units(M, "xpress_huff", dev, tallies["xpress_huff"],
                         xh_sources, range(n_plain))
    xh_fast = fuzz_units(M, "xpress_huff", dev, tallies["xpress_huff"],
                         resolved, range(n_plain, FUZZ_UNIT_BATCHES),
                         fast=True)
    for k in range(FUZZ_ONESHOT):
        m = M.mutant("xpress_huff", ten_src, SEED + 18, k, "block_edge")
        oneshot.add(m, host_outcome(lambda s, n: xh.decompress(
            s, n, device=dev), m.stream, m.out_len),
            host_outcome(_native.xh_decompress, m.stream, m.out_len))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {}
    for fn in counters:
        name = ENTRY_OF.get(fn.__name__, fn.__name__)
        launches[name] = launches.get(name, 0) + fn.launches
    print(f"fuzz main path launches: {launches}")
    for label, t in (("fuzz lznt1", tallies["lznt1"]),
                     ("fuzz xpress", tallies["xpress"]),
                     ("fuzz xpress_huff (of them "
                      f"{FUZZ_RESOLVED * FUZZ_ROWS} resolved, fast_resolve)",
                      tallies["xpress_huff"]),
                     ("fuzz xpress_huff one-shot, 10 blocks, at the block "
                      "tables", oneshot)):
        print(t.line(label))
        require(not t.unlisted, f"{label}: disagreements in no listed class "
                f"(seed, index, operator): {t.unlisted[:10]}")
    require(min(t.n for t in tallies.values()) >= FUZZ_MIN,
            f"fewer than {FUZZ_MIN} mutants a format")
    for name in FUZZ_KERNELS:
        require(launches.get(name, 0) > 0, f"{name} never launched on the "
                "fuzz path")
    print(f"fuzz main path: {main_s:.2f} s on the host clock")

    # ---- 18. each decode kernel against its plain version, exactly
    t0 = time.perf_counter()
    errs: dict = {}
    for args in lz_kept:
        parsed = hold(errs, "lznt1_parse", "LZNT1", lznt1_parse.lznt1_parse,
                      lznt1_parse.lznt1_parse_ref, args)
        vpack = hold(errs, "fill_records", "LZNT1", fill.fill_records_delta,
                     fill.fill_records_delta_ref,
                     (parsed[0], parsed[1], lz.CHUNK))
        is_copy = (vpack & lznt1_parse.COPY_BIT) != 0
        near = hold(errs, "resolve_near", "LZNT1", resolve.resolve_near,
                    resolve.resolve_near_ref,
                    (is_copy, vpack & (lznt1_parse.COPY_BIT - 1),
                     torch.where(is_copy, 0, vpack & 0xFF)))
        hold(errs, "far_level", "LZNT1", gather.far_level,
             gather.far_level_ref, (near,))
    # Xpress and XH: the parse on the shortest rows of a batch, alone and
    # as rows of the whole batch's launch; the tail on the whole batch
    payload, plen, out_len = xp_kept[0]
    sub = fuzz_shortest(plen)
    parsed = xp_parse.xp_parse(payload, plen, out_len, UNIT)
    hold_parse(errs, "xp_parse", "Xpress", xp_parse.xp_parse,
               xp_parse.xp_parse_ref, parsed, sub,
               (payload[sub], plen[sub], out_len[sub], UNIT))
    hold_tail(errs, "Xpress", parsed[0], parsed[1], None, False)
    for batch, fast in ((xh_kept[0], False), (xh_fast[0], True)):
        label = "XH" + (", resolved" if fast else "")
        args = xh.parse_inputs(*batch)
        sub = fuzz_shortest(batch[1])
        parsed = xh_parse.xh_parse(*args, UNIT)
        hold_parse(errs, "xh_parse", label, xh_parse.xh_parse,
                   xh_parse.xh_parse_ref, parsed, sub,
                   (*(a[sub] for a in args), UNIT))
        hold_tail(errs, label, parsed[0], parsed[1], UNIT, fast)
    torch.cuda.synchronize()
    print(f"fuzz kernels against their plain versions, exactly: "
          f"{sorted(errs)} (max abs err {max(errs.values())}); "
          f"{time.perf_counter() - t0:.2f} s")
    print(f"phase 18: {time.perf_counter() - started:.2f} s ({smi})")
    return launches, errs


def main() -> None:
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    started = time.perf_counter()
    sys.path.insert(0, ROOT)
    import tpucomp_torch
    from benchmarks.corpus import silesia_like
    from tpucomp_torch.codecs import lznt1 as lz
    from tpucomp_torch.kernels import (_build, common, fill, gather,
                                       lznt1_parse, resolve)

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
    trace_kernels(data[:DIST_TWO_RANK_BYTES], "before phase 3")

    # ---- 3. kernel vs plain -----------------------------------------------
    payload, plen, is_comp = lz.pack_chunks(payloads, comps, dev)
    N = payload.shape[0]
    bad = malformed_rows(payload, plen, is_comp, rng)
    parse_in = (payload, plen, is_comp)
    parsed = lznt1_parse.lznt1_parse(*parse_in)
    windows = lznt1_parse.lznt1_parse.windows.double()
    parsed_ref = lznt1_parse.lznt1_parse_ref(*parse_in)
    kernels = []
    vpack = fill_case(kernels, "LZNT1", fill.fill_records_delta,
                      fill.fill_records_delta_ref,
                      (parsed[0], parsed[1], lz.CHUNK), plain_reps=5)
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
        # the parse reads each payload as far as its plen
        moved = nbytes(*got) + (
            nbytes(*args[1:]) + int(plen.sum()) if name == "lznt1_parse"
            else nbytes(*args))
        print(f"{name}: equal to plain; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound "
              f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms")
        if name == "lznt1_parse":
            walked = windows[:, 0] > 0
            planes = [torch.empty_like(got[0]) for _ in range(2)]
            b2b = statistics.median(burst_ms(lambda: fn(*args), reps=5))
            fill_b2b = statistics.median(burst_ms(lambda: (
                planes[0].fill_(lznt1_parse.SENT),
                planes[1].fill_(lznt1_parse.EMPTY_VAL)), reps=5))
            print(f"lznt1_parse: windows a walked row mean "
                  f"{float(windows[walked, 0].mean()):.4f} (max "
                  f"{int(windows[:, 0].max())}), redone mean "
                  f"{float(windows[walked, 1].mean()):.4f} (max "
                  f"{int(windows[:, 1].max())}); back to back "
                  f"({BURST} calls a run) {b2b:.4f} ms, fill_ of the two "
                  f"record planes (the same bytes written) {fill_b2b:.4f} ms")
            del planes
        kernels.append(kernel_entry(name, replaces, max_err, ms, plain_ms,
                                    moved))
    far_level_case(kernels, "LZNT1", (near,))
    del parsed, parsed_ref, vpack, is_copy, near_in, near, near_ref, far, far_ref

    # ---- 4. main path ----------------------------------------------------
    units = [data[i:i + UNIT] for i in range(0, CORPUS_BYTES, UNIT)]
    unit_streams = [native.lznt1_compress(u) for u in units]
    corrupt = (0xB000 | 2).to_bytes(2, "little") + bytes([1, 0, 0])
    path = {"lznt1_parse": lznt1_parse.lznt1_parse,
            "fill_records": fill.fill_records_delta,
            "resolve_near": resolve.resolve_near,
            "far_level": gather.far_level}
    for fn in path.values():
        fn.launches = 0
    out = tpucomp_torch.decompress("lznt1", stream, device="cuda")
    out_units = tpucomp_torch.decompress_batch("lznt1", unit_streams,
                                               device="cuda")
    try:
        tpucomp_torch.decompress("lznt1", corrupt, device="cuda")
        raised = False
    except tpucomp_torch.DataError:
        raised = True
    launches = {name: fn.launches for name, fn in path.items()}
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

    # ---- 7-8. LZNT1 encode --------------------------------------------------
    enc_launches = encode_phases(dev, data, native, stream, kernels)
    for k in kernels:
        k["launches"] = k.get("launches", 0) + enc_launches.get(k["name"], 0)
    # ---- 9-10. plain Xpress ------------------------------------------------
    xp_launches = xpress_phases(dev, units, native, kernels)
    for k in kernels:
        k["launches"] = k.get("launches", 0) + xp_launches.get(k["name"], 0)
    # ---- 11-12. XH encode -------------------------------------------------
    xhe_launches = xh_encode_phases(dev, units, native, kernels)
    for k in kernels:
        k["launches"] = k.get("launches", 0) + xhe_launches.get(k["name"], 0)
    # ---- 13-14. XH one-shot decompress ------------------------------------
    xho_launches = xh_oneshot_phases(dev, data, native, kernels)
    for k in kernels:
        k["launches"] = k.get("launches", 0) + xho_launches.get(k["name"], 0)
    # ---- 15. plain Xpress single-stream encode ----------------------------
    xps_launches = xp_stream_phases(dev, data, native, kernels, smi)
    for k in kernels:
        k["launches"] = k.get("launches", 0) + xps_launches.get(k["name"], 0)
    # ---- 16. the dist layer ------------------------------------------------
    dist_launches = dist_phases(data, native, kernels, smi)
    for k in kernels:
        k["launches"] += dist_launches.get(k["name"], 0)
    # ---- 17. the streaming API ----------------------------------------------
    stream_launches = stream_phases(data, native, smi)
    for k in kernels:
        k["launches"] += stream_launches.get(k["name"], 0)
    # ---- 18. the decoders on mutated streams --------------------------------
    fuzz_launches, fuzz_errs = fuzz_phases(dev, data, stream, units, smi)
    for k in kernels:
        k["fuzz"] = fuzz_launches.get(k["name"], 0)
        k["launches"] += k["fuzz"]
        k["max_abs_err"] = max(k["max_abs_err"], fuzz_errs.get(k["name"], 0))
    require(len(kernels) == 12, f"{len(kernels)} kernels in the line, not 12")
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - started:.1f} s ({smi})")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        dist_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()

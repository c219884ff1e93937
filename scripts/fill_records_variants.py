"""Time the record fill (``tpucomp_torch/kernels/csrc/fill_records.cu``) on
one CUDA card, beside other builds of it: ``--baseline PATH`` a source of
the entry point ``fill_records(rec_pos, rec_val, val_out, pos_out, ovf,
n, R, U, keep, stream)`` as it stood before the tiled kernel (for example
the one-block-a-row ``fill_records.cu`` of an older commit, which has no
value-only form), and ``--variant PATH`` (repeatable) another source of
the kernel's own entry points.

Inputs: LZNT1's records ([8208, 4616] -> [8208, 4096], value plane:
``chip_smoke.py`` phase 3's batch, the corpus's chunks with 256
malformed rows), XH's ([546, 65536], phase 5's batch: 512 corpus units, a
random and a zeros unit, 32 malformed rows), plain Xpress's ([546,
73712] -> [546, 65536], phase 9's), the zeros unit's XH row alone, and
546 rows of 65536 literals.  Every build's output must equal the plain
version's.  Then each is timed with CUDA events, all builds in turn,
three times over, and the median of those turns' medians printed beside
the bound (``chip_smoke.fill_bytes`` at 3.35 TB/s: rec_pos read whole,
rec_val's 32-byte sectors that hold a real record, the output planes
written once): once a call (as ``chip_smoke.py`` times it), in runs of
``chip_smoke.BURST`` calls back to back (the card's own time), and the
host's time to issue one call (a clock around the call, the card idle,
no wait for it: while it runs the card waits, so a call's time exceeds
its back-to-back time by about as much), beside a yardstick of the
card's rate for this traffic: ``clone()`` of the two record planes (read
and written) and ``fill_`` of the output planes.

Run from the repo's root on a machine with a card:
``python3 scripts/fill_records_variants.py [--baseline PATH]
[--variant PATH]``.  It exits nonzero without CUDA.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 5
TURNS = 3


def corpus(smoke):
    from benchmarks.corpus import silesia_like

    rng = np.random.default_rng(smoke.SEED)
    data = (silesia_like(smoke.CORPUS_BYTES) + rng.integers(
        0, 256, smoke.RANDOM_TAIL, dtype=np.uint8).tobytes())
    return data, rng


def lznt1_records(smoke, native, data, rng, dev):
    """Phase 3's records: the corpus's chunks, 256 of them malformed."""
    from tpucomp_torch.codecs import lznt1 as lz
    from tpucomp_torch.kernels import lznt1_parse

    payloads, comps = lz.split_stream(native.lznt1_compress(data))
    payload, plen, is_comp = lz.pack_chunks(payloads, comps, dev)
    smoke.malformed_rows(payload, plen, is_comp, rng)
    return lznt1_parse.lznt1_parse(payload, plen, is_comp)[:2]


def xh_records(smoke, native, units, dev):
    """Phase 5's records, and the row of its zeros unit."""
    from tpucomp_torch.codecs import xpress_huff as xh
    from tpucomp_torch.kernels import xh_parse

    rng = np.random.default_rng(smoke.SEED + 1)
    units = smoke.xh_units(units, rng)
    streams = [native.xh_compress(u) for u in units]
    shortest = sorted(range(len(units) - 2), key=lambda i: len(streams[i]))[
        :smoke.XH_SUB_SHORTEST]
    rows = list(zip(streams, map(len, units))) + smoke.xh_malformed(
        native, units, streams, shortest, rng)
    batch = xh.pack_units([s for s, _ in rows], [n for _, n in rows],
                          smoke.UNIT, dev)
    rec = xh_parse.xh_parse(*xh.parse_inputs(*batch), smoke.UNIT)[:2]
    return rec, len(units) - 1


def xpress_records(smoke, native, units, dev):
    """Phase 9's records."""
    from tpucomp_torch.codecs import xpress as xp
    from tpucomp_torch.kernels import xp_parse

    U = smoke.UNIT
    rng = np.random.default_rng(smoke.SEED + 3)
    units = list(units) + [rng.integers(0, 256, U, dtype=np.uint8).tobytes(),
                           bytes(U)]
    streams = [native.xpress_compress(u) for u in units]
    shortest = sorted(range(len(units) - 2), key=lambda i: len(streams[i]))[
        :smoke.XP_SUB_SHORTEST]
    rows = list(zip(streams, map(len, units))) + smoke.xp_malformed(
        native, units, streams, shortest, rng)
    batch = xp.pack_units([s for s, _ in rows], [o for _, o in rows], U, dev)
    return xp_parse.xp_parse(*batch, U)[:2]


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="a source of fill_records with the "
                    "one-block-a-row entry point")
    ap.add_argument("--variant", action="append", default=[],
                    help="another source of the kernel's entry points")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("fill_records_variants: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from tpucomp_torch.kernels import _build, fill

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    src = os.path.join(os.path.dirname(_build.__file__), "csrc",
                       "fill_records.cu")
    builds = {"kernel": src}  # name -> source
    for path in opts.variant:
        builds[f"variant {path}"] = path
    baseline = f"baseline ({opts.baseline})"
    if opts.baseline:
        builds[baseline] = opts.baseline
    nvcc = _build.find_nvcc()
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        paths = {name: pool.submit(
            _build.shared_library, nvcc, _build.NVCC_FLAGS, [path],
            "fill_records_variant") for name, path in builds.items()}
        libs = {}
        for name, f in paths.items():
            path, log = f.result()
            libs[name] = ctypes.CDLL(path)
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  nvcc ({name}): {line.strip()}")

    def run(name, rec_pos, rec_val, U, value_only):
        """One launch of build ``name``: the value plane, or (val, pos,
        ovf); the baseline computes both planes either way."""
        N, R = rec_pos.shape
        val = torch.empty((N, U), dtype=torch.int32, device=dev)
        pos, ovf = torch.empty_like(val), torch.empty(N, dtype=torch.int32,
                                                      device=dev)
        if name == baseline:
            _build.launch("fill_records", [rec_pos, rec_val, val, pos, ovf],
                          [N, R, U, min(R, U)], lib=libs[name])
            return val if value_only else (val, pos, ovf)
        T, TS, threads = fill.tiles(R)
        summary = fill._summary(N, T, rec_pos)
        vec = [fill._vec_in(rec_pos, rec_val), int(U % 4 == 0)]
        if value_only:
            _build.launch("fill_records_value",
                          [rec_pos, rec_val, summary, val],
                          [N, R, U, T, TS, threads, *vec], lib=libs[name])
            return val
        _build.launch("fill_records",
                      [rec_pos, rec_val, summary, val, pos, ovf],
                      [N, R, U, min(R, U), T, TS, threads, *vec],
                      lib=libs[name])
        return val, pos, ovf

    native = smoke.Native()
    data, rng = corpus(smoke)
    U = smoke.UNIT
    units = [data[i:i + U] for i in range(0, smoke.CORPUS_BYTES, U)]
    (xh_pos, xh_val), z = xh_records(smoke, native, units, dev)
    N = xh_pos.shape[0]
    gen = torch.Generator(dev).manual_seed(smoke.SEED)
    cases = {
        "LZNT1 [8208, 4616] -> value plane [8208, 4096]": (
            *lznt1_records(smoke, native, data, rng, dev), 4096, True),
        "XH [546, 65536] -> two planes": (xh_pos, xh_val, U, False),
        "Xpress [546, 73712] -> two planes": (
            *xpress_records(smoke, native, units, dev), U, False),
        "XH, the zeros unit's row alone": (
            xh_pos[z:z + 1], xh_val[z:z + 1], U, False),
        "546 rows of 65536 literals": (
            torch.arange(U, dtype=torch.int32, device=dev).expand(
                N, U).contiguous(),
            torch.randint(0, 256, (N, U), dtype=torch.int32, device=dev,
                          generator=gen), U, False),
    }
    for case, (rec_pos, rec_val, width, value_only) in cases.items():
        if value_only:
            want = (fill.fill_records_delta_ref(rec_pos, rec_val, width),)
        else:
            want = fill.fill_records_delta2_ref(rec_pos, rec_val, width)
        for name in builds:
            got = run(name, rec_pos, rec_val, width, value_only)
            got = (got,) if value_only else got
            smoke.require(all(map(torch.equal, got, want)),
                          f"{name} differs from the plain fill on {case}")
        moved = smoke.fill_bytes(rec_pos, width, want)
        print(f"{case}: every build equal to the plain fill; bound "
              f"{moved / smoke.HBM_BYTES_PER_S * 1e3:.4f} ms")
        runs = {name: lambda name=name: run(name, rec_pos, rec_val, width,
                                            value_only) for name in builds}
        planes = [torch.empty_like(w) for w in want]
        runs["clone + fill_ (yardstick)"] = lambda: (
            rec_pos.clone(), rec_val.clone(), [p.fill_(0) for p in planes])
        smoke.time_in_turns(runs, TURNS, REPS)


if __name__ == "__main__":
    main()

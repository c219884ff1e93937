"""Time the full-row far level (``tpucomp_torch/kernels/csrc/far_row.cu``)
on one CUDA card, and with ``--baseline PATH`` another source of the
level built and timed beside it: a source of the entry point ``far_row(in,
out, scratch, n, U, cap, stream)`` as it stood before the kernel took a
``looped`` output (for example the round-loop ``far_row.cu`` of an older
commit).

Inputs, each [546, 65536]: the XH states of ``chip_smoke.py`` phase 5
after the 4 KiB level and the probes (512 corpus units of 64 KiB, a unit
of seeded random bytes, one of zeros, 32 malformed rows), the plain
Xpress states of phase 9 after the 4 KiB level, rows with no tag (the
sweep's staging and stores alone), and rows that are one chain of
displacement 1 (a byte, then a tag to the position before: the deepest
chains inside every chunk, 12 doubling rounds each).  The kernel's
output must equal its plain version's and every build's the kernel's;
the script prints how many rows took the round loop.  Then each is timed
with CUDA events, all builds in turn, three times over, and the median of
those turns' medians printed beside the bound: once a call (as
``chip_smoke.py`` times it: the host's launch work shows while the card
waits for it) and in runs of ``chip_smoke.BURST`` calls back to back (the
card's own time, the host's work hidden behind the calls before it),
(the states read once, the output written once, at 3.35 TB/s) and beside
``x.clone()``, one PyTorch call that moves the same bytes (a yardstick of
the card's rate for this traffic, not the same function).

Run from the repo's root on a machine with a card:
``python3 scripts/far_row_variants.py [--baseline PATH]``.  It exits
nonzero without CUDA.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 5
TURNS = 3


def corpus_units(smoke):
    from benchmarks.corpus import silesia_like

    data = silesia_like(smoke.CORPUS_BYTES)
    return [data[i:i + smoke.UNIT]
            for i in range(0, smoke.CORPUS_BYTES, smoke.UNIT)]


def xh_states(smoke, native, units, dev):
    """Phase 5's far_row input: the batch after the 4 KiB level and the
    probes."""
    from tpucomp_torch.codecs import xpress_huff as xh
    from tpucomp_torch.kernels import common, fill, gather, resolve, xh_parse

    rng = np.random.default_rng(smoke.SEED + 1)
    units = smoke.xh_units(units, rng)
    streams = [native.xh_compress(u) for u in units]
    shortest = sorted(range(len(units) - 2), key=lambda i: len(streams[i]))[
        :smoke.XH_SUB_SHORTEST]
    rows = list(zip(streams, map(len, units))) + smoke.xh_malformed(
        native, units, streams, shortest, rng)
    batch = xh.pack_units([s for s, _ in rows], [n for _, n in rows],
                          smoke.UNIT, dev)
    rec_pos, rec_val, _, _ = xh_parse.xh_parse(*xh.parse_inputs(*batch),
                                               smoke.UNIT)
    filled = fill.fill_records_delta2(rec_pos, rec_val, smoke.UNIT,
                                      smoke.UNIT)
    near = resolve.resolve_near(*xh.near_inputs(filled[0], filled[1]))
    seg = gather.far_level(near, common.SEG_LEVEL, common.SEG_LEVEL_CAP,
                           False)
    return gather.far_probe(seg)


def xpress_states(smoke, native, units, dev):
    """Phase 9's far_row input: the batch after the 4 KiB level."""
    from tpucomp_torch.codecs import xpress as xp
    from tpucomp_torch.codecs.xpress_huff import near_inputs
    from tpucomp_torch.kernels import common, fill, gather, resolve, xp_parse

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
    rec_pos, rec_val, _, _ = xp_parse.xp_parse(*batch, U)
    filled = fill.fill_records_delta2(rec_pos, rec_val, U)
    near = resolve.resolve_near(*near_inputs(filled[0], filled[1]))
    return gather.far_level(near, common.SEG_LEVEL, common.SEG_LEVEL_CAP,
                            False)


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another source of far_row (the "
                    "entry point without the looped output)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("far_row_variants: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from tpucomp_torch.kernels import _build, common, gather

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    src = os.path.join(os.path.dirname(_build.__file__), "csrc", "far_row.cu")
    builds = {"kernel": src}
    if opts.baseline:
        builds[f"baseline ({opts.baseline})"] = opts.baseline
    nvcc = _build.find_nvcc()
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        paths = {name: pool.submit(
            _build.shared_library, nvcc, _build.NVCC_FLAGS, [path],
            "far_row_variant") for name, path in builds.items()}
        libs = {}
        for name, f in paths.items():
            path, log = f.result()
            libs[name] = ctypes.CDLL(path)
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  nvcc ({name}): {line.strip()}")

    native = smoke.Native()
    units = corpus_units(smoke)
    N, U = 546, smoke.UNIT
    gen = torch.Generator(dev).manual_seed(smoke.SEED)
    no_tags = torch.randint(0, 256, (N, U), dtype=torch.int32, device=dev,
                            generator=gen)
    chain = no_tags.clone()
    chain[:, 1:] = common.FAR_TAG | torch.arange(
        U - 1, dtype=torch.int32, device=dev)
    cases = {
        "XH after the probes [546, 65536]": xh_states(smoke, native, units,
                                                      dev),
        "Xpress after the 4 KiB level [546, 65536]": xpress_states(
            smoke, native, units, dev),
        "no tags [546, 65536]": no_tags,
        "chain of displacement 1 [546, 65536]": chain,
    }

    def level(name, x):
        out, scratch = torch.empty_like(x), torch.empty_like(x)
        n, u = x.shape
        # the older entry point takes no looped output
        looped = ([torch.empty(n, dtype=torch.int32, device=dev)]
                  if name == "kernel" else [])
        _build.launch("far_row", [x, out, scratch, *looped],
                      [n, u, common.level_cap(u)], lib=libs[name])
        return out

    for case, x in cases.items():
        tags = int(((x & common.FAR_TAG) != 0).sum())
        want = gather.far_row(x)
        looped = int(gather.far_row.looped.sum())
        smoke.require(torch.equal(want, gather.far_row_ref(x)),
                      f"the kernel differs from its plain version on {case}")
        for name in builds:
            smoke.require(torch.equal(level(name, x), want),
                          f"{name} differs from the kernel on {case}")
        bound = smoke.nbytes(x, want) / smoke.HBM_BYTES_PER_S * 1e3
        print(f"{case}: {tags} tags, {looped} rows on the round loop; every "
              f"build equal to the kernel; bound {bound:.4f} ms")
        runs = {name: lambda name=name: level(name, x) for name in builds}
        runs["clone (same bytes)"] = x.clone
        turns = {(name, how): [] for name in runs
                 for how in ("a call", f"in runs of {smoke.BURST}")}
        for _ in range(TURNS):
            for name, fn in runs.items():
                turns[name, "a call"].append(statistics.median(
                    smoke.cuda_ms(fn, reps=REPS)))
                turns[name, f"in runs of {smoke.BURST}"].append(
                    statistics.median(smoke.burst_ms(fn, reps=REPS)))
        for (name, how), ms in turns.items():
            print(f"  {name}, {how}: {statistics.median(ms):.4f} ms (turns "
                  f"{', '.join(f'{t:.4f}' for t in ms)})")


if __name__ == "__main__":
    main()

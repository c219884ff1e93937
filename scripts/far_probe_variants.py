"""Time the archive probe (``tpucomp_torch/kernels/csrc/far_probe.cu``) on
one CUDA card, beside other builds of it: ``--baseline PATH`` a source of
the entry point ``far_probe(in, out, scratch, n, U, rounds, stream)`` as
it stood before the one-pass kernel (the round-by-round ``far_probe.cu``
of an older commit, its state swapped between ``out`` and ``scratch``),
and ``--variant PATH`` (repeatable) another source of the kernel's own
entry point ``far_probe(in, out, n, U, rounds, stream)``.

Inputs, int32 [N, 65536] states after the 4 KiB far level: XH's [546,
65536] (``chip_smoke.py`` phase 5: 512 corpus units, a random and a zeros
unit, 32 malformed rows) and the same units encoded as resolved archives
([514, 65536], the states the ``fast_resolve`` path probes), at
tpucomp's two rounds; 546 rows that each hold one chain of 61440 tags
(each pointing one back, the probe's longest walk), at 1, 2 and 5 rounds;
546 rows with no tag.  Every build's output must equal the plain
version's.  Then each is timed with CUDA events, all builds in turn,
three times over, and the median of those turns' medians printed beside
the bound (the plane read once and written once, at 3.35 TB/s): a call
(as ``chip_smoke.py`` times it), in runs of ``chip_smoke.BURST`` calls
back to back (the card's own time), and the host's time to issue one
call, beside a yardstick of the card's rate for this traffic: ``clone()``
of the plane.

Run from the repo's root on a machine with a card:
``python3 scripts/far_probe_variants.py [--baseline PATH]
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


def far_states(smoke, native, dev):
    """Phase 5's states after the 4 KiB level, and those of the same units
    encoded as resolved archives (depth 2)."""
    from benchmarks.corpus import silesia_like
    from tpucomp_torch.codecs import xpress_huff as xh
    from tpucomp_torch.kernels import fill, gather, resolve, xh_parse
    from tpucomp_torch.kernels.common import SEG_LEVEL, SEG_LEVEL_CAP

    U = smoke.UNIT
    data = silesia_like(smoke.CORPUS_BYTES)
    rng = np.random.default_rng(smoke.SEED + 1)
    units = smoke.xh_units([data[i:i + U] for i in range(0, len(data), U)],
                           rng)
    streams = [native.xh_compress(u) for u in units]
    shortest = sorted(range(len(units) - 2), key=lambda i: len(streams[i]))[
        :smoke.XH_SUB_SHORTEST]
    rows = list(zip(streams, map(len, units))) + smoke.xh_malformed(
        native, units, streams, shortest, rng)
    resolved = [native.xh_compress_opt(
        u, smoke.Native.OPT_RESOLVE_OFFSETS | 2 << 8) for u in units]

    def states(streams, lens):
        batch = xh.pack_units(streams, lens, U, dev)
        rec = xh_parse.xh_parse(*xh.parse_inputs(*batch), U)
        val, pos, _ = fill.fill_records_delta2(rec[0], rec[1], U, U)
        near = resolve.resolve_near(*xh.near_inputs(val, pos))
        return gather.far_level(near, SEG_LEVEL, SEG_LEVEL_CAP, False)

    return (states([s for s, _ in rows], [n for _, n in rows]),
            states(resolved, list(map(len, units))))


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="a source of far_probe with the "
                    "round-by-round entry point")
    ap.add_argument("--variant", action="append", default=[],
                    help="another source of the kernel's entry point")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("far_probe_variants: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from tpucomp_torch.kernels import _build, gather
    from tpucomp_torch.kernels.common import ARCHIVE_PROBE_BUDGET, FAR_TAG

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    src = os.path.join(os.path.dirname(_build.__file__), "csrc",
                       "far_probe.cu")
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
            f"far_probe_variant{k}")
            for k, (name, path) in enumerate(builds.items())}
        libs = {}
        for name, f in paths.items():
            path, log = f.result()
            libs[name] = ctypes.CDLL(path)
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  nvcc ({name}): {line.strip()}")

    def run(name, x, rounds):
        """One launch of build ``name`` on the states ``x``."""
        N, U = x.shape
        out = torch.empty_like(x)
        if name == baseline:
            scratch = torch.empty_like(x) if rounds > 1 else out
            _build.launch("far_probe", [x, out, scratch], [N, U, rounds],
                          lib=libs[name])
        else:
            _build.launch("far_probe", [x, out], [N, U, rounds],
                          lib=libs[name])
        return out

    xh_states, resolved_states = far_states(smoke, smoke.Native(), dev)
    N, U = xh_states.shape
    gen = torch.Generator(dev).manual_seed(smoke.SEED)
    chain = torch.randint(0, 256, (N, U), dtype=torch.int32, device=dev,
                          generator=gen)
    chain[:, 4096:] = FAR_TAG | torch.arange(4095, U - 1, dtype=torch.int32,
                                             device=dev)
    cases = {
        f"XH [{N}, {U}]": (xh_states, ARCHIVE_PROBE_BUDGET),
        f"resolved archive [{resolved_states.shape[0]}, {U}]": (
            resolved_states, ARCHIVE_PROBE_BUDGET),
        **{f"chain rows [{N}, {U}], rounds = {r}": (chain, r)
           for r in (1, 2, 5)},
        f"no tag [{N}, {U}]": (chain & 0xFF, ARCHIVE_PROBE_BUDGET),
    }
    for case, (x, rounds) in cases.items():
        want = gather.far_probe_ref(x, rounds)
        for name in builds:
            smoke.require(torch.equal(run(name, x, rounds), want),
                          f"{name} differs from the plain version on {case}")
        tags = [int(((t & FAR_TAG) != 0).sum()) for t in (x, want)]
        moved = smoke.nbytes(x, want)
        print(f"{case}: every build equal to the plain version; tags "
              f"{tags[0]} -> {tags[1]}; bound "
              f"{moved / smoke.HBM_BYTES_PER_S * 1e3:.4f} ms")
        del want
        fns = {name: lambda name=name: run(name, x, rounds)
               for name in builds}
        fns["clone() (yardstick)"] = lambda: x.clone()
        smoke.time_in_turns(fns, TURNS, REPS)


if __name__ == "__main__":
    main()

"""Time the run matcher (``tpucomp_torch/kernels/csrc/run_matchlens.cu``) on
one CUDA card, beside other builds of it: ``--baseline PATH`` a source of
the entry point ``run_matchlens(x, out, n, U, D, d0, d1, d2, d3, stream)``
as it stood before the tiled kernel (the one-block-a-row
``run_matchlens.cu`` of an older commit), and ``--variant PATH``
(repeatable) another source of the kernel's own entry point
``run_matchlens(x, first, out, n, U, D, d0, d1, d2, d3, stream)``.

Inputs, at the encoders' displacements (1, 2, 3): LZNT1's [8208, 4096]
(``chip_smoke.py`` phase 7: the corpus's chunks), plain Xpress's [514,
65536] (phase 9: 512 corpus units, a random and a zeros unit), XH's
[514, 65536] (phase 11: another random unit), 514 all-zero rows (every
run crosses every tile edge), the zeros unit's row alone and 514 rows of
random bytes (no run crosses an edge).  Every build's output must equal
the plain version's.  Then each is timed with CUDA events, all builds in
turn, three times over, and the median of those turns' medians printed
beside the bound (the bytes read once and the planes written once, at
3.35 TB/s): a call (as ``chip_smoke.py`` times it), in runs of
``chip_smoke.BURST`` calls back to back (the card's own time), and the
host's time to issue one call, beside a yardstick of the card's rate for
this traffic: ``x.clone()`` and ``fill_`` of the output planes.

Run from the repo's root on a machine with a card:
``python3 scripts/run_matchlens_variants.py [--baseline PATH]
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


def byte_rows(smoke, dev):
    """The run matcher's inputs at the main paths' shapes: LZNT1's
    chunks, and plain Xpress's and XH's units as [514, 65536] rows."""
    import torch

    from benchmarks.corpus import silesia_like
    from tpucomp_torch.codecs import lznt1 as lz

    rng = np.random.default_rng(smoke.SEED)
    data = (silesia_like(smoke.CORPUS_BYTES) + rng.integers(
        0, 256, smoke.RANDOM_TAIL, dtype=np.uint8).tobytes())
    chunks = torch.from_numpy(lz.split_chunks(data)[0]).to(dev)
    U = smoke.UNIT
    units = [data[i:i + U] for i in range(0, smoke.CORPUS_BYTES, U)]
    xp_rng = np.random.default_rng(smoke.SEED + 3)
    xp_units = units + [xp_rng.integers(0, 256, U, dtype=np.uint8).tobytes(),
                        bytes(U)]
    xh = smoke.xh_units(units, np.random.default_rng(smoke.SEED + 1))

    def rows(us):
        return torch.from_numpy(np.stack([np.frombuffer(u, np.uint8)
                                          for u in us])).to(dev)

    return chunks, rows(xp_units), rows(xh)


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="a source of run_matchlens with the "
                    "one-block-a-row entry point")
    ap.add_argument("--variant", action="append", default=[],
                    help="another source of the kernel's entry point")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("run_matchlens_variants: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from tpucomp_torch.config import DEFAULT as MATCH
    from tpucomp_torch.kernels import _build, runs

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    src = os.path.join(os.path.dirname(_build.__file__), "csrc",
                       "run_matchlens.cu")
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
            f"run_matchlens_variant{k}")
            for k, (name, path) in enumerate(builds.items())}
        libs = {}
        for name, f in paths.items():
            path, log = f.result()
            libs[name] = ctypes.CDLL(path)
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  nvcc ({name}): {line.strip()}")

    disps = tuple(MATCH.run_disps)

    def run(name, x):
        """One launch of build ``name``: the D planes [D, N, U]."""
        N, U = x.shape
        out = torch.empty((len(disps), N, U), dtype=torch.int32, device=dev)
        ints = [N, U, len(disps), *disps, *(0,) * (4 - len(disps))]
        if name == baseline:
            _build.launch("run_matchlens", [x, out], ints, lib=libs[name])
        else:
            first = torch.empty((N, -(-U // runs.TILE), 4), dtype=torch.int32,
                                device=dev)
            _build.launch("run_matchlens", [x, first, out], ints,
                          lib=libs[name])
        return out

    chunks, xp_rows, xh_rows = byte_rows(smoke, dev)
    gen = torch.Generator(dev).manual_seed(smoke.SEED)
    cases = {
        "LZNT1 [8208, 4096]": chunks,
        "Xpress [514, 65536]": xp_rows,
        "XH [514, 65536]": xh_rows,
        "514 all-zero rows": torch.zeros_like(xp_rows),
        "the zeros unit's row alone": xp_rows[-1:],
        "514 rows of random bytes": torch.randint(
            0, 256, xp_rows.shape, dtype=torch.uint8, device=dev,
            generator=gen),
    }
    for case, x in cases.items():
        want = torch.stack(runs.run_matchlens_ref(x, disps))
        for name in builds:
            smoke.require(torch.equal(run(name, x), want),
                          f"{name} differs from the plain version on {case}")
        moved = smoke.nbytes(x, want)
        print(f"{case}, d = {disps}: every build equal to the plain version; "
              f"bound {moved / smoke.HBM_BYTES_PER_S * 1e3:.4f} ms")
        del want
        fns = {name: lambda name=name: run(name, x) for name in builds}
        planes = torch.empty((len(disps), *x.shape), dtype=torch.int32,
                             device=dev)
        fns["x.clone() + fill_ (yardstick)"] = lambda: (x.clone(),
                                                        planes.fill_(0))
        smoke.time_in_turns(fns, TURNS, REPS)


if __name__ == "__main__":
    main()

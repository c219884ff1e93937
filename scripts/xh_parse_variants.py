"""Time the XH parse kernel (``tpucomp_torch/kernels/csrc/xh_parse.cu``)
against builds of it that each leave one of its mechanisms out, on one
CUDA card:

- ``no fast table``: every symbol through the 14 level compares
  (``-DXH_DROP=1``);
- ``no W0/W1 turn``: a refill word's two bytes in two turns of the byte
  loop (``-DXH_DROP=2``);
- ``no tier-3 sub-segments``: a tier-3 row's final pass one thread a
  coarse segment (``-DXH_DROP=4``);
- ``16 hypotheses from c = 0``: tier-3 segments under 16 entry
  hypotheses with 0 to 15 bits left over, 16 coarse segments a row
  (``-DXH_HYP=16 -DXH_HYP_LO=0``);
- ``launch order``: the kernel as built, its blocks in row order rather
  than tier-3 rows first (the wrapper's ``argsort``).

Inputs: the 546-row batch of ``chip_smoke.py`` phase 5 (512 corpus units
of 64 KiB, a unit of seeded random bytes, one of zeros, 32 malformed
rows), the random unit alone, and a batch of 514 units of seeded random
bytes (every row at substep tier 3).  Every variant's records, p_final and
err must equal the kernel's; then each is timed with CUDA events, all
variants in turn, three times over, and the median of those turns'
medians printed.

Run from the repo's root on a machine with a card:
``python3 scripts/xh_parse_variants.py``.  It exits nonzero without CUDA.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANDOM = 514
REPS = 5
TURNS = 3

VARIANTS = {  # name: (extra nvcc flags, hypotheses, tier-3 rows first)
    "kernel": ([], 8, True),
    "launch order": ([], 8, False),
    "no fast table": (["-DXH_DROP=1"], 8, True),
    "no W0/W1 turn": (["-DXH_DROP=2"], 8, True),
    "no tier-3 sub-segments": (["-DXH_DROP=4"], 8, True),
    "16 hypotheses from c = 0": (["-DXH_HYP=16", "-DXH_HYP_LO=0"], 16, True),
}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("xh_parse_variants: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from benchmarks.corpus import silesia_like
    from tpucomp_torch.codecs import xpress_huff as xh
    from tpucomp_torch.kernels import _build, xh_parse

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    src = os.path.join(os.path.dirname(_build.__file__), "csrc",
                       "xh_parse.cu")
    nvcc = _build.find_nvcc()
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = {name: pool.submit(
            _build.shared_library, nvcc, _build.NVCC_FLAGS + flags, [src],
            "xh_parse_variant") for name, (flags, _, _) in VARIANTS.items()}
        libs = {name: ctypes.CDLL(f.result()[0]) for name, f in paths.items()}

    # chip_smoke.py phase 5's batch, the same seeds
    data = silesia_like(smoke.CORPUS_BYTES)
    units = [data[i:i + smoke.UNIT]
             for i in range(0, smoke.CORPUS_BYTES, smoke.UNIT)]
    native = smoke.Native()
    rng = np.random.default_rng(smoke.SEED + 1)
    units = smoke.xh_units(units, rng)
    streams = [native.xh_compress(u) for u in units]
    n_corpus = len(units) - 2
    shortest = sorted(range(n_corpus), key=lambda i: len(streams[i]))[
        :smoke.XH_SUB_SHORTEST]
    rows = list(zip(streams, map(len, units))) + smoke.xh_malformed(
        native, units, streams, shortest, rng)
    rr = np.random.default_rng(smoke.SEED + 9)
    randoms = [rr.integers(0, 256, smoke.UNIT, dtype=np.uint8).tobytes()
               for _ in range(N_RANDOM)]

    def inputs(rows):
        batch = xh.pack_units([s for s, _ in rows], [o for _, o in rows],
                              smoke.UNIT, dev)
        return tuple(a.contiguous() for a in xh.parse_inputs(*batch))

    cases = {
        f"whole batch ({len(rows)} rows)": inputs(rows),
        "random unit alone": inputs([rows[n_corpus]]),
        f"{N_RANDOM} random units": inputs(
            [(native.xh_compress(u), len(u)) for u in randoms]),
    }
    U = smoke.UNIT

    def parse(name, args):
        _, hyp, first = VARIANTS[name]
        N, Pb = args[0].shape
        order = (torch.argsort((args[3] != 3).to(torch.uint8), stable=True)
                 if first else torch.arange(N, device=dev)).to(torch.int32)
        rec_pos = torch.empty((N, U), dtype=torch.int32, device=dev)
        rec_val = torch.empty_like(rec_pos)
        p_final, err, span, rounds = (
            torch.empty(N, dtype=torch.int32, device=dev) for _ in range(4))
        hist_len = torch.zeros(N, dtype=torch.int32, device=dev)
        scratch = torch.empty((N, xh_parse.THREADS, hyp - 1, xh_parse.REC),
                              dtype=torch.int32, device=dev)
        _build.launch("xh_parse", list(args) + [
            hist_len, order, rec_pos, rec_val, p_final, err, span, rounds,
            scratch], [N, Pb, U], lib=libs[name])
        return (rec_pos, rec_val, p_final, err), rounds

    for case, args in cases.items():
        want = xh_parse.xh_parse(*args, U)
        for name in VARIANTS:
            got, rounds = parse(name, args)
            smoke.require(all(torch.equal(g, w) for g, w in zip(got, want)),
                          f"{name} differs from the kernel on the {case}")
        tier3 = args[3] == 3
        r = xh_parse.xh_parse.rounds.float()
        print(f"{case}: {int(tier3.sum())} tier-3 rows (segments re-decoded "
              f"max {int(r[tier3].max()) if bool(tier3.any()) else 0}), "
              f"every variant equal to the kernel")
        turns = {name: [] for name in VARIANTS}
        for _ in range(TURNS):
            for name in VARIANTS:
                turns[name].append(statistics.median(smoke.cuda_ms(
                    lambda: parse(name, args), reps=REPS)))
        for name, ms in turns.items():
            print(f"  {name}: {statistics.median(ms):.4f} ms (turns "
                  f"{', '.join(f'{t:.4f}' for t in ms)})")


if __name__ == "__main__":
    main()

"""Time the plain Xpress parse kernel
(``tpucomp_torch/kernels/csrc/xp_parse.cu``) against builds of it that
each leave one of its mechanisms out, on one CUDA card:

- ``no literal words together``: a flag word of 32 literals walked as
  any other, not with up to 31 more in one step (``-DXP_DROP=1``);
- ``no unchecked walk``: every flag word walked token by token with
  every check of the byte machine, not in warp rounds without them
  (``-DXP_DROP=2``);
- ``no emission beside the walk``: the emitters wait for the walk's end
  before the first window (``-DXP_DROP=4``).

Inputs: the 546-row batch of ``chip_smoke.py`` phase 9 (512 corpus units
of 64 KiB, a unit of seeded random bytes, one of zeros, 32 malformed
rows), its 64-row sub-batch, the random unit alone, and a batch of 514
units of seeded random bytes.  Every variant's records, p_final, err and
steps must equal the kernel's; then each is timed with CUDA events, all
variants in turn, three times over, and the median of those turns'
medians printed, with the walk's steps.

Run from the repo's root on a machine with a card:
``python3 scripts/xp_parse_variants.py``.  It exits nonzero without CUDA.
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

VARIANTS = {  # name: extra nvcc flags
    "kernel": [],
    "no literal words together": ["-DXP_DROP=1"],
    "no unchecked walk": ["-DXP_DROP=2"],
    "no emission beside the walk": ["-DXP_DROP=4"],
}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("xp_parse_variants: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from benchmarks.corpus import silesia_like
    from tpucomp_torch.codecs import xpress as xp
    from tpucomp_torch.kernels import _build, xp_parse

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    src = os.path.join(os.path.dirname(_build.__file__), "csrc",
                       "xp_parse.cu")
    nvcc = _build.find_nvcc()
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = {name: pool.submit(
            _build.shared_library, nvcc, _build.NVCC_FLAGS + flags, [src],
            "xp_parse_variant") for name, flags in VARIANTS.items()}
        libs = {name: ctypes.CDLL(f.result()[0]) for name, f in paths.items()}

    # chip_smoke.py phase 9's batch, the same seeds
    data = silesia_like(smoke.CORPUS_BYTES)
    units = [data[i:i + smoke.UNIT]
             for i in range(0, smoke.CORPUS_BYTES, smoke.UNIT)]
    native = smoke.Native()
    rng = np.random.default_rng(smoke.SEED + 3)
    units += [rng.integers(0, 256, smoke.UNIT, dtype=np.uint8).tobytes(),
              bytes(smoke.UNIT)]
    streams = [native.xpress_compress(u) for u in units]
    n_corpus = len(units) - 2
    shortest = sorted(range(n_corpus), key=lambda i: len(streams[i]))[
        :smoke.XP_SUB_SHORTEST]
    rows = list(zip(streams, map(len, units))) + smoke.xp_malformed(
        native, units, streams, shortest, rng)
    U = smoke.UNIT
    batch = xp.pack_units([s for s, _ in rows], [o for _, o in rows], U, dev)
    sub = torch.tensor(shortest + list(range(len(units), len(rows))),
                       device=dev)
    rr = np.random.default_rng(smoke.SEED + 9)
    randoms = [rr.integers(0, 256, U, dtype=np.uint8).tobytes()
               for _ in range(N_RANDOM)]
    cases = {
        f"whole batch ({len(rows)} rows)": batch,
        f"sub-batch ({len(sub)} rows)": tuple(a[sub] for a in batch),
        "random unit alone": tuple(a[n_corpus:n_corpus + 1] for a in batch),
        f"{N_RANDOM} random units": xp.pack_units(
            [native.xpress_compress(u) for u in randoms], [U] * N_RANDOM, U,
            dev),
    }

    def parse(name, args):
        N, P = args[0].shape
        rec_pos = torch.empty((N, P), dtype=torch.int32, device=dev)
        rec_val = torch.empty_like(rec_pos)
        p_final, err, steps = (torch.empty(N, dtype=torch.int32, device=dev)
                               for _ in range(3))
        max_words = P // xp_parse.WORD_MIN + 2
        entries = torch.empty((N, max_words, xp_parse.ENTRY),
                              dtype=torch.int32, device=dev)
        _build.launch("xp_parse", list(args) + [
            rec_pos, rec_val, p_final, err, steps, entries],
            [N, P, U, max_words], lib=libs[name])
        return rec_pos, rec_val, p_final, err, steps

    for case, args in cases.items():
        want = (*xp_parse.xp_parse(*args, U), xp_parse.xp_parse.steps)
        for name in VARIANTS:
            got = parse(name, args)
            smoke.require(all(torch.equal(g, w) for g, w in zip(got, want)),
                          f"{name} differs from the kernel on the {case}")
        st = want[4].float()
        print(f"{case}: skeleton steps max {int(st.max())}, mean "
              f"{float(st.mean()):.4f}; every variant equal to the kernel")
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

"""Time the LZNT1 parse (``tpucomp_torch/kernels/csrc/lznt1_parse.cu``) on
one CUDA card, beside other builds of it: ``--variant PATH`` (repeatable)
a source of the same entry point, ``--baseline PATH`` a source of the
entry point as it stood before the kernel took a ``windows`` output (for
example the thread-a-chunk ``lznt1_parse.cu`` of an older commit).

Inputs, each [8208, 4616] (LZNT1's payload pad): ``chip_smoke.py`` phase
3's batch (the corpus's chunks by the native C encoder, 256 rows replaced
by seeded malformed ones), chunks of 4096 literals (the longest walk:
129 windows), chunks of random bytes parsed as tokens (most malformed,
the walk stops early) and stored chunks (no walk: the tail fill alone).
The kernel's output must equal the plain parse's and every build's the
kernel's; the script prints the rows' windows and redone windows.  Then
each is timed with CUDA events, all builds in turn, three times over,
and the median of those turns' medians printed beside the bound (the
payload read as far as plen, the other inputs and the outputs moved
once, at 3.35 TB/s): once a call (as ``chip_smoke.py`` times it: the
host's launch work shows while the card waits for it) and in runs of
``chip_smoke.BURST`` calls back to back (the card's own time), beside a
yardstick that writes the same record bytes: ``fill_`` of the two [N, P]
int32 planes.

Run from the repo's root on a machine with a card:
``python3 scripts/lznt1_parse_variants.py [--variant PATH] [--baseline
PATH]``.  It exits nonzero without CUDA.
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


def corpus_batch(smoke, dev):
    """Phase 3's batch: the corpus's chunks, 256 of them malformed."""
    from benchmarks.corpus import silesia_like
    from tpucomp_torch.codecs import lznt1 as lz

    rng = np.random.default_rng(smoke.SEED)
    data = (silesia_like(smoke.CORPUS_BYTES) + rng.integers(
        0, 256, smoke.RANDOM_TAIL, dtype=np.uint8).tobytes())
    payloads, comps = lz.split_stream(smoke.Native().lznt1_compress(data))
    payload, plen, is_comp = lz.pack_chunks(payloads, comps, dev)
    smoke.malformed_rows(payload, plen, is_comp, rng)
    return payload, plen, is_comp


def synthetic_batches(N, P, dev):
    """All-literal, random-byte and stored chunks, each [N, P]."""
    import torch

    gen = torch.Generator(dev).manual_seed(20261017)
    rnd = torch.randint(0, 256, (N, P), dtype=torch.uint8, device=dev,
                        generator=gen)
    # 512 groups: a zero flag byte, then 8 literals
    lit = rnd.clone()
    lit[:, 0:4608:9] = 0
    full = torch.full((N,), 4608, dtype=torch.int32, device=dev)
    rlen = torch.randint(1, P + 1, (N,), dtype=torch.int32, device=dev,
                         generator=gen)
    yes = torch.ones(N, dtype=torch.bool, device=dev)
    return {"4096 literals a chunk": (lit, full, yes),
            "random bytes": (rnd, rlen, yes),
            "stored": (rnd, rlen, ~yes)}


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="another source of lznt1_parse (the same entry "
                    "point)")
    ap.add_argument("--baseline", help="a source of lznt1_parse without "
                    "the windows output")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("lznt1_parse_variants: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from tpucomp_torch.kernels import _build, lznt1_parse

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    src = os.path.join(os.path.dirname(_build.__file__), "csrc",
                       "lznt1_parse.cu")
    builds = {"kernel": src}
    for path in opts.variant:
        builds[f"variant ({path})"] = path
    if opts.baseline:
        builds[f"baseline ({opts.baseline})"] = opts.baseline
    nvcc = _build.find_nvcc()
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        paths = {name: pool.submit(
            _build.shared_library, nvcc, _build.NVCC_FLAGS, [path],
            "lznt1_parse_variant") for name, path in builds.items()}
        libs = {}
        for name, f in paths.items():
            path, log = f.result()
            libs[name] = ctypes.CDLL(path)
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    print(f"  nvcc ({name}): {line.strip()}")

    cases = {"phase 3's batch (corpus, 256 malformed)":
             corpus_batch(smoke, dev)}
    N, P = cases[next(iter(cases))][0].shape
    cases.update(synthetic_batches(N, P, dev))

    def parse(name, batch):
        payload, plen, is_comp = batch
        rec_pos = torch.empty((N, P), dtype=torch.int32, device=dev)
        rec_val = torch.empty_like(rec_pos)
        fin = [torch.empty(N, dtype=torch.int32, device=dev)
               for _ in range(2)]
        # the older entry point takes no windows output
        windows = ([torch.empty((N, 2), dtype=torch.int32, device=dev)]
                   if not name.startswith("baseline") else [])
        _build.launch("lznt1_parse", [payload, plen, is_comp, rec_pos,
                                      rec_val, *fin, *windows], [N, P],
                      lib=libs[name])
        return rec_pos, rec_val, *fin

    for case, batch in cases.items():
        want = lznt1_parse.lznt1_parse(*batch)
        windows = lznt1_parse.lznt1_parse.windows.double()
        ref = lznt1_parse.lznt1_parse_ref(*batch)
        smoke.require(all(torch.equal(a, b) for a, b in zip(want, ref)),
                      f"the kernel differs from its plain version on {case}")
        for name in builds:
            smoke.require(all(torch.equal(a, b) for a, b in zip(
                parse(name, batch), want)), f"{name} differs from the "
                f"kernel on {case}")
        plen = torch.where(batch[2], batch[1].clamp(0, P), 0)
        moved = smoke.nbytes(*want, batch[1], batch[2]) + int(plen.sum())
        bound = moved / smoke.HBM_BYTES_PER_S * 1e3
        walked = windows[:, 0] > 0
        mean = [float(windows[walked, c].mean()) if walked.any() else 0.0
                for c in (0, 1)]
        records = float((want[0] != lznt1_parse.SENT).sum(1).double().mean())
        print(f"{case} [{N}, {P}]: every build equal to the kernel; "
              f"{int(walked.sum())} rows walked, windows a row mean "
              f"{mean[0]:.4f} (max {int(windows[:, 0].max())}), redone mean "
              f"{mean[1]:.4f} (max {int(windows[:, 1].max())}); records a "
              f"row mean {records:.4f}; bound {bound:.4f} ms")
        planes = [torch.empty((N, P), dtype=torch.int32, device=dev)
                  for _ in range(2)]
        runs = {name: lambda name=name: parse(name, batch) for name in builds}
        runs["fill_ of the two record planes (same bytes written)"] = (
            lambda: (planes[0].fill_(lznt1_parse.SENT),
                     planes[1].fill_(lznt1_parse.EMPTY_VAL)))
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

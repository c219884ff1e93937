"""Time the near walk (``tpucomp_torch/kernels/csrc/resolve_near.cu``)
on one CUDA card, and with ``--baseline PATH`` another source of the same
entry point (for example an older ``resolve_near.cu`` or a different
resolve) built and timed beside it.

Inputs: LZNT1's [8208, 4096] planes as ``chip_smoke.py`` phase 3 builds
them from its corpus (without its malformed rows), the same shape with a
run of displacement 1 in every segment (511 hops: the deepest chains)
and with literals only (no chain: staging and stores alone), and the
Xpress planes of phase 9 ([546, 65536]: 512 corpus units of 64 KiB, a
unit of seeded random bytes, one of zeros, 32 malformed rows).  Every
build's output must equal the kernel's, and the kernel's its plain
version's; then each is timed with CUDA events, all builds in turn, three
times over, and the median of those turns' medians printed beside the
bound (13 bytes a position at 3.35 TB/s) and beside
``torch.where(is_copy, disp, litv)``, one PyTorch call that moves the
same bytes (a yardstick of the card's rate for this traffic, not the
same function).

Run from the repo's root on a machine with a card:
``python3 scripts/resolve_near_variants.py [--baseline PATH]``.  It exits
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

def lznt1_planes(smoke, native, dev):
    """Phase 3's near-walk inputs, the corpus's chunks only."""
    import torch

    from benchmarks.corpus import silesia_like
    from tpucomp_torch.codecs import lznt1 as lz
    from tpucomp_torch.kernels import common, lznt1_parse

    rng = np.random.default_rng(smoke.SEED)
    data = (silesia_like(smoke.CORPUS_BYTES) + rng.integers(
        0, 256, smoke.RANDOM_TAIL, dtype=np.uint8).tobytes())
    payloads, comps = lz.split_stream(native.lznt1_compress(data))
    parsed = lznt1_parse.lznt1_parse(*lz.pack_chunks(payloads, comps, dev))
    vpack = common.fill_records_delta(parsed[0], parsed[1], lz.CHUNK)
    is_copy = (vpack & lznt1_parse.COPY_BIT) != 0
    return (is_copy, vpack & (lznt1_parse.COPY_BIT - 1),
            torch.where(is_copy, 0, vpack & 0xFF))


def xpress_planes(smoke, native, dev):
    """Phase 9's near-walk inputs."""
    from benchmarks.corpus import silesia_like
    from tpucomp_torch.codecs import xpress as xp
    from tpucomp_torch.codecs.xpress_huff import near_inputs
    from tpucomp_torch.kernels import fill, xp_parse

    U = smoke.UNIT
    data = silesia_like(smoke.CORPUS_BYTES)
    units = [data[i:i + U] for i in range(0, smoke.CORPUS_BYTES, U)]
    rng = np.random.default_rng(smoke.SEED + 3)
    units += [rng.integers(0, 256, U, dtype=np.uint8).tobytes(), bytes(U)]
    streams = [native.xpress_compress(u) for u in units]
    n_corpus = len(units) - 2
    shortest = sorted(range(n_corpus), key=lambda i: len(streams[i]))[
        :smoke.XP_SUB_SHORTEST]
    rows = list(zip(streams, map(len, units))) + smoke.xp_malformed(
        native, units, streams, shortest, rng)
    batch = xp.pack_units([s for s, _ in rows], [o for _, o in rows], U, dev)
    rec_pos, rec_val, _, _ = xp_parse.xp_parse(*batch, U)
    filled = fill.fill_records_delta2(rec_pos, rec_val, U)
    return near_inputs(filled[0], filled[1])


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another source of resolve_near")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("resolve_near_variants: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from tpucomp_torch.kernels import _build, resolve

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    src = os.path.join(os.path.dirname(_build.__file__), "csrc",
                       "resolve_near.cu")
    builds = {"kernel": src}
    if opts.baseline:
        builds[f"baseline ({opts.baseline})"] = opts.baseline
    nvcc = _build.find_nvcc()
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        paths = {name: pool.submit(
            _build.shared_library, nvcc, _build.NVCC_FLAGS, [path],
            "resolve_near_variant") for name, path in builds.items()}
        libs = {}
        for name, f in paths.items():
            path, log = f.result()
            libs[name] = ctypes.CDLL(path)
            for line in log.splitlines():
                if "resolve_near" in line or "registers" in line:
                    print(f"  nvcc ({name}): {line.strip()}")

    native = smoke.Native()
    N, U = 8208, 4096
    j = torch.arange(N * U, device=dev).reshape(N, U) % resolve.SEG
    litv = torch.randint(0, 256, (N, U), dtype=torch.int32, device=dev,
                         generator=torch.Generator(dev).manual_seed(smoke.SEED))
    cases = {
        "LZNT1 corpus [8208, 4096]": lznt1_planes(smoke, native, dev),
        "run of displacement 1 [8208, 4096]": (
            j != 0, torch.ones((N, U), dtype=torch.int32, device=dev), litv),
        "literals only [8208, 4096]": (
            torch.zeros((N, U), dtype=torch.bool, device=dev),
            torch.zeros((N, U), dtype=torch.int32, device=dev), litv),
        "Xpress [546, 65536]": xpress_planes(smoke, native, dev),
    }

    def walk(name, args):
        out = torch.empty_like(args[1])
        n, u = out.shape
        _build.launch("resolve_near", [*args, out],
                      [n * (u // resolve.SEG), u // resolve.SEG],
                      lib=libs[name])
        return out

    for case, args in cases.items():
        want = resolve.resolve_near(*args)
        smoke.require(torch.equal(want, resolve.resolve_near_ref(*args)),
                      f"the kernel differs from its plain version on {case}")
        for name in builds:
            smoke.require(torch.equal(walk(name, args), want),
                          f"{name} differs from the kernel on {case}")
        bound = smoke.nbytes(*args, want) / smoke.HBM_BYTES_PER_S * 1e3
        print(f"{case}: every build equal to the kernel; bound "
              f"{bound:.4f} ms")
        runs = {name: lambda name=name: walk(name, args) for name in builds}
        runs["torch.where (same bytes)"] = lambda: torch.where(*args)
        turns = {name: [] for name in runs}
        for _ in range(TURNS):
            for name, fn in runs.items():
                turns[name].append(statistics.median(smoke.cuda_ms(
                    fn, reps=REPS)))
        for name, ms in turns.items():
            print(f"  {name}: {statistics.median(ms):.4f} ms (turns "
                  f"{', '.join(f'{t:.4f}' for t in ms)})")


if __name__ == "__main__":
    main()

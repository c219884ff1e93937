"""Where one LZNT1 device call's time goes at small batches: the cost a
streaming ``Compressor`` / ``Decompressor`` pays a feed.

On one NVIDIA GPU: ``codecs.lznt1.compress`` and ``decompress`` of the
first N chunks of ``benchmarks.corpus.silesia_like`` for N = 1 to 2048
(CUDA events around each call, median of 5 after a warm-up); then, for
one chunk, the encode's steps and ``find_matches``'s stages on the host
clock (each synchronised, median of 5) and one call under
``torch.profiler``: the CUDA runtime calls it made (kernel launches,
copies, synchronisations) and the host ops with the most self time.
Every line carries the card's name and power limit.

    python3 scripts/lznt1_call_split.py
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNKS = (1, 2, 8, 64, 512, 2048)
REPS = 5
RUNTIME_CALLS = ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaMalloc",
                 "cudaFree", "cudaStreamSynchronize", "cudaDeviceSynchronize")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("lznt1_call_split: torch.cuda.is_available() is "
                         "False")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from benchmarks.corpus import silesia_like
    from torch.profiler import ProfilerActivity, profile
    from tpucomp_torch.codecs import lznt1 as lz
    from tpucomp_torch.config import DEFAULT as m
    from tpucomp_torch.kernels import _build, match, runs
    from tpucomp_torch.kernels.commit import greedy_commit_layout

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    _build.build()
    data = silesia_like(max(CHUNKS) * lz.CHUNK)
    dev = torch.device("cuda", 0)
    for n in CHUNKS:
        d = data[:n * lz.CHUNK]
        s = lz.compress(d, device="cuda")
        enc = cs.cuda_ms(lambda: lz.compress(d, device="cuda"), reps=REPS)
        dec = cs.cuda_ms(lambda: lz.decompress(s, device="cuda"), reps=REPS)
        print(f"{n} chunks ({smi}): compress {statistics.median(enc):.4f} "
              f"ms, decompress {statistics.median(dec):.4f} ms, median of "
              f"{REPS}")

    d = data[:lz.CHUNK]
    steps: dict = {}
    for _ in range(REPS):
        ch, cl = cs.clock(steps, "split_chunks + upload", lambda: tuple(
            torch.from_numpy(a).to(dev) for a in lz.split_chunks(d)))
        bl, bd, use, ok = cs.clock(steps, "find_matches",
                                   lambda: lz.find_matches(ch, cl))
        walk = cs.clock(steps, "greedy_commit_layout",
                        lambda: greedy_commit_layout(use, bl, ok))
        p, pl = cs.clock(steps, "assemble_payload",
                         lambda: lz.assemble_payload(ch, bl, bd, use, *walk))
        cs.clock(steps, "copy back + frame", lambda: lz.frame_chunks(
            p.cpu().numpy(), pl.cpu().numpy(), ch.cpu().numpy(),
            cl.cpu().numpy()))
        # find_matches's stages at the default MatchFinderConfig
        cs.clock(steps, "run_matchlens",
                 lambda: runs.run_matchlens(ch, tuple(m.run_disps)))
        hl, hd = cs.clock(steps, "hash_best_match", lambda: (
            match.hash_best_match(ch, lz.CHUNK, pos_bits=12,
                                  hash_bits=m.hash_bits,
                                  num_cands=m.num_candidates, cap=m.cap)))
        cs.clock(steps, "extend_saturated",
                 lambda: match.extend_saturated(hl, hd, m.cap, lz.CHUNK))
    print(f"1 chunk ({smi}), host clock, each step synchronised, median of "
          f"{REPS} (ms; the last three are find_matches's stages): "
          + "; ".join(f"{k} {statistics.median(v):.4f}"
                      for k, v in steps.items()))
    s = lz.compress(d, device="cuda")
    for label, fn in (("compress", lambda: lz.compress(d, device="cuda")),
                      ("decompress", lambda: lz.decompress(s,
                                                           device="cuda"))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        print(f"1 chunk {label} under torch.profiler ({smi}): " + "; ".join(
            f"{e.key} {e.count} calls, {e.cpu_time_total / 1e3:.4f} ms host"
            for e in ka if e.key in RUNTIME_CALLS))
        for e in sorted(ka, key=lambda e: -e.self_cpu_time_total)[:10]:
            print(f"  self host {e.self_cpu_time_total / 1e3:.4f} ms in "
                  f"{e.count}: {e.key[:100]}")


if __name__ == "__main__":
    main()

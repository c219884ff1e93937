"""Decode the pools of many seeds of a benchmark read cell on the card and
compare every set with its data.

    python3 scripts/read_sweep.py --workload <cell> --seeds <n> \\
        [--first <seed>] [--processes <k>] [--device <d>] [--out <file>]

Makes the pool inputs of seeds ``first``, ``first + 1``, ... (``--seeds``
of them) as ``portbench`` makes them (its frozen encoder's streams of
the configuration's data, the sets stored raw left out), in ``k`` helper
processes that send back the streams and a digest of each set, and
decodes each input through the port's public call of the cell
(``decompress_batch`` or ``decompress``) on ``--device`` (``cuda``).
A call that raises is decoded again set by set, to name the sets at
fault.  Prints
one JSON line: the seeds, inputs, sets and bytes decoded, the sets whose
bytes differ, and those the port refuses (with their seed, input and
index), and the card's name.
"""

import argparse
import hashlib
import json
import multiprocessing
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _made(job):
    """Input ``k`` of ``seed`` (``job``: config, cell, seed, k): its
    streams, decoded lengths and the digest of each set."""
    from portbench import inputs

    config, cell, seed, k = job
    x = inputs.make(config, cell, seed, k)
    return (seed, k, x["streams"], [len(u) for u in x["units"]],
            [hashlib.sha256(u).digest() for u in x["units"]])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, required=True)
    parser.add_argument("--first", type=int, default=2**31 + 2600)
    parser.add_argument("--processes", type=int, default=8)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import tpucomp_torch as tt
    from portbench import frozen, spec
    from tpucomp_torch.errors import DataError

    cell = spec.cell(args.workload)
    config = spec.config(cell["config"])
    fmt, api = config["format"], cell["api"]
    if api not in ("decompress", "decompress_batch"):
        raise SystemExit(f"{args.workload} is not a read cell")
    frozen.build()
    dev = torch.device(args.device)

    def decode(streams, lens):
        if api == "decompress_batch":
            return tt.decompress_batch(fmt, streams, lens, device=dev)
        out = tt.decompress(fmt, b"".join(streams), None if config.get(
            "self_terminating") else sum(lens), device=dev)
        cut, at = [], 0
        for n in lens:
            cut.append(out[at:at + n])
            at += n
        return cut

    jobs = [(config, cell, args.first + s, k) for s in range(args.seeds)
            for k in range(cell["pool"])]
    counts = {"inputs": 0, "sets": 0, "bytes": 0}
    wrong, refused = [], []
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(args.processes) as pool:
        for seed, k, streams, lens, digests in pool.imap_unordered(
                _made, jobs, chunksize=1):
            try:
                outs = [decode(streams, lens)]
                index = [range(len(streams))]
            except DataError:
                outs, index = [], []
                for i in range(len(streams)):
                    try:
                        outs.append(decode([streams[i]], [lens[i]]))
                        index.append([i])
                    except DataError as e:
                        refused.append({"seed": seed, "input": k, "set": i,
                                        "error": str(e)})
            for out, idx in zip(outs, index):
                for o, i in zip(out, idx):
                    if hashlib.sha256(o).digest() != digests[i]:
                        wrong.append({"seed": seed, "input": k, "set": i})
            counts["inputs"] += 1
            counts["sets"] += len(streams)
            counts["bytes"] += sum(lens)
        pool.close()
        pool.join()
    line = {"workload": args.workload, "first_seed": args.first,
            "seeds": args.seeds, **counts, "wrong": wrong,
            "refused": refused, "seconds": time.perf_counter() - t0,
            "device": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else dev.type}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 1 if wrong or refused else 0


if __name__ == "__main__":
    sys.exit(main())

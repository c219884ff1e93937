"""The control of a cell's check: the reference put in the program's place
with one of the configuration's guarantees broken, whose outputs the
check has to find wrong.

* A read cell's control is the format's reference decoder
  (``ref/<format>.py``) with ``block_copies``: each match copied as one
  block, as a memmove copies it, so that the bit-exact decode breaks
  wherever a match overlaps its own output.
* A write cell's control is the format's frozen encoder
  (``<format>_compress``) built with ``-DPORTBENCH_CONTROL``: the
  encoders of ``frozen/codec.c`` then take a hash candidate's 3 hashed
  bytes as matching without comparing them (a finder that trusts its
  hash): a hash collision makes a match of other bytes, and the stream
  no longer decodes to what was written.  A format whose source takes
  no notice of ``PORTBENCH_CONTROL`` has no control, and is refused.

    python3 portbench/control.py --workload <cell> --seed <n> [--seed <m> ...]

makes each input of the cell's pool from each seed, at the cell's own
sizes, gives it to the control, and runs the run's own check on the
output.  It prints one JSON line a seed, with the check's numbers and
``correct``, which has to come out false.  The benchmark's runs never
run it; it needs no card.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import frozen, harness, inputs, ref, spec  # noqa: E402


def control_output(config: dict, cell: dict, x: dict,
                   root: str = spec.ROOT):
    """What the control returns for pool input ``x``: the format's
    reference and frozen encoder under ``root``, found by its name."""
    fmt, api = config["format"], cell["api"]
    if api == "decompress":
        return b"".join(ref.decode(fmt, [x["arg"]], [len(x["expect"])],
                                   block_copies=True, root=root))
    if api == "decompress_batch":
        return ref.decode(fmt, *x["arg"], block_copies=True, root=root)
    if api == "compress":
        return frozen.compress(fmt, x["arg"], control=True, root=root)
    return [frozen.compress(fmt, u, control=True, root=root)
            for u in x["arg"]]


def one(config: dict, cell: dict, seed: int, k: int,
        root: str = spec.ROOT) -> dict:
    """The check's numbers for the control's output of input ``k``."""
    x = inputs.make(config, cell, seed, k, root)
    tally = harness.check(config, cell, seed, [x],
                          [(0, control_output(config, cell, x, root))],
                          root)
    return {"answers_checked": tally.checked, "answers_wrong": tally.wrong,
            "bytes_wrong": tally.bytes, "inputs_wrong": tally.inputs_wrong}


def run(workload: str, seeds: list, processes: int) -> list:
    """One result a seed: the check's numbers summed over the pool."""
    cell = spec.cell(workload)
    config = spec.config(cell["config"])
    frozen.build(control=True)
    frozen.build()
    jobs = [(config, cell, s, k) for s in seeds for k in range(cell["pool"])]
    with multiprocessing.get_context("spawn").Pool(processes) as pool:
        parts = pool.starmap(one, jobs)
        pool.close()
        pool.join()
    out = []
    for s in seeds:
        mine = [p for (_, _, js, _), p in zip(jobs, parts) if js == s]
        total = {key: sum(p[key] for p in mine) for key in mine[0]}
        total["correct"] = (total["answers_wrong"] == 0
                            and total["bytes_wrong"] == 0
                            and total["inputs_wrong"] == 0
                            and total["answers_checked"] >= 1)
        out.append({"workload": workload, "seed": s, **total})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, action="append", required=True)
    parser.add_argument("--processes", type=int,
                        default=min(8, os.cpu_count() or 1))
    args = parser.parse_args(argv)
    for line in run(args.workload, args.seed, args.processes):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

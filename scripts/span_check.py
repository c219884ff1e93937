"""Hold the port's spans and counters to the profiler's own trace in a
benchmark cell.

    python3 scripts/span_check.py --workload <cell> --seed <n> \\
        [--root <checkout>] [--out <file>]

Runs the cell's traced calls through ``portbench``'s harness (what
``portbench/run.py --trace 1`` runs) from the checkout at ``--root``
(default: this one), and prints one JSON line: the result line's
per-layer metrics and idle gaps, the share of the listed idle seconds
named ``portbench.call (no aten op)``, and the median of the calls'
spans.  Where the program keeps span records
(``tpucomp_torch.stats.spans``), it adds each call's coverage (the
seconds of its ``api.*`` span inside its child spans, over the span;
all of them, their least and their median),
the bytes the program counts as copied (``h2d_bytes`` + ``d2h_bytes``)
against the bytes of the trace's ``Memcpy HtoD`` / ``DtoH`` records, the
self milliseconds a call of each span name, and the launches a call of
each kernel wrapper.  ``--out`` appends the line to a file too.
"""

import argparse
import json
import os
import statistics
import sys
import time

T0 = time.perf_counter()
NO_OP = "portbench.call (no aten op)"


def _ms(r) -> float:
    return (r.end_ns - r.start_ns) * 1e-6


def program_numbers(records: list, events: list) -> dict:
    """Coverage, bytes and per-name times of the traced calls' records."""
    roots = [i for i, r in enumerate(records)
             if r.parent is None and r.name.startswith("api.")]
    calls = {records[i].request: i for i in roots}
    child_ms = [0.0] * len(records)
    for r in records:
        if r.parent is not None:
            child_ms[r.parent] += _ms(r)
    cover = [child_ms[i] / _ms(records[i]) for i in roots if _ms(records[i])]
    by_name, counts = {}, {}
    for r, inner in zip(records, child_ms):
        if r.request not in calls:
            continue
        by_name[r.name] = by_name.get(r.name, 0.0) + _ms(r) - inner
        for k, n in r.counters.items():
            counts[k] = counts.get(k, 0) + n
    copied = sum(e.get("args", {}).get("bytes", 0) for e in events
                 if e.get("cat") == "gpu_memcpy"
                 and e["name"].startswith(("Memcpy HtoD", "Memcpy DtoH")))
    counted = counts.get("h2d_bytes", 0) + counts.get("d2h_bytes", 0)
    n = max(len(roots), 1)
    return {
        "calls": len(roots),
        "coverage_min": min(cover, default=None),
        "coverage_median": statistics.median(cover) if cover else None,
        "coverage": cover,
        "bytes_counted": counted, "bytes_traced": copied,
        "bytes_ratio": counted / copied if copied else None,
        "self_ms_per_call": dict(sorted(
            ((k, v / n) for k, v in by_name.items()), key=lambda x: -x[1])),
        "counters_per_call": {k: v / n for k, v in sorted(counts.items())},
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from portbench import harness, spec, trace

    # the build and kernel caches where portbench/run.py keeps them
    for var, sub in {"TORCH_EXTENSIONS_DIR": "torch_extensions",
                     "TRITON_CACHE_DIR": "triton",
                     "CUDA_CACHE_PATH": "cuda"}.items():
        os.environ[var] = os.path.join(spec.ROOT, ".build", sub)
    bench = spec.benchmark()
    cell = spec.cell(args.workload)
    config = spec.config(cell["config"])
    e2e, layer = spec.cell_metrics(bench, args.workload)
    made = harness.Inputs(config, cell, args.seed, harness.helpers_for(cell))
    kept = {}
    summarize = trace.summarize

    def keep(events, works):
        kept["events"] = events
        kept["summary"] = summarize(events, works)
        return kept["summary"]

    trace.summarize = keep
    try:
        result = harness.run(cell, config, e2e, layer, args.seed, 30.0, True,
                             t_start=T0, made=made)
    finally:
        made.close()
        trace.summarize = summarize
    gaps = result.get("breakdown", {}).get("idle_gaps", [])
    idle = sum(s for _, s in gaps)
    line = {
        "workload": args.workload, "seed": args.seed, "root": root,
        "correct": result["correct"], "metrics": {
            k: v["value"] for k, v in result["metrics"].items()},
        "idle_gaps": gaps,
        "no_op_share": (sum(s for n, s in gaps if n == NO_OP) / idle
                        if idle else None),
        "call_span_ms_median": 1e3 * statistics.median(
            c["span_s"] for c in kept["summary"]["calls"]),
        "call_span_ms": [1e3 * c["span_s"]
                         for c in kept["summary"]["calls"]],
    }
    from tpucomp_torch import stats

    if hasattr(stats, "spans"):
        line["program"] = program_numbers(stats.spans(), kept["events"])
    text = json.dumps(line)
    print(text)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

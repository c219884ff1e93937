"""Run one cell of the benchmark of tpucomp_torch on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number the check compared, with its limit; the same numbers are the last
lines of standard error.

Without a CUDA card (or with fewer than the cell asks for) the run exits
with status 2 and prints no result; so does a run that finds ``jax``,
``jaxlib``, ``flax`` or ``tpucomp`` loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed place inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import harness, spec

    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(spec.ROOT, ".build", sub)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: {', '.join(found)} loaded at start",
              file=sys.stderr)
        return 2
    bench = spec.benchmark()
    work = spec.workload(bench, args.workload)
    cell = spec.cell(args.workload)
    config = spec.config(cell["config"])
    e2e, layer = spec.cell_metrics(bench, args.workload)
    # the helpers make the inputs while torch, CUDA and the program start
    made = harness.Inputs(config, cell, args.seed, harness.helpers_for(cell))
    try:
        import torch

        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < work["chips"]):
            print(f"portbench: the cell needs {work['chips']} CUDA card(s); "
                  f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        result = harness.run(cell, config, e2e, layer, args.seed,
                             args.seconds, bool(args.trace), t_start=T0,
                             made=made, chips=work["chips"])
    finally:
        made.close()
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: {', '.join(found)} loaded by the run",
              file=sys.stderr)
        return 2
    for err in result["errors"]:
        print(f"portbench: a call failed: {err}", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the benchmark finds its parts, by name.

Every part that belongs to one configuration, one cell or one metric is
a file of its own, found by its name in ``BENCHMARK.json``:

* ``configs/<config>.json``: a deployment (format, sizes, guarantees,
  data mix, source, what was assumed and reduced);
* ``cells/<cell>.json``: a cell's traffic (its configuration, the API
  entry, clients, call sizes, pool, checks, why);
* ``metrics/<metric>.py``, else ``metrics/<metric up to its first
  dot>.py``: the reader of a metric, a function ``read(ctx)`` that
  returns the metric's value, or None where it finds nothing to read.

A configuration names its ``format``, whose parts are found by that name
too:

* ``ref/<format>.py``: the plain reference decoder, a function
  ``decode_units(streams, out_lens, block_copies=False)`` that returns
  each unit stream's decoded bytes and raises ValueError on a malformed
  stream (``portbench.ref``);
* a ``frozen/*.c`` that exports ``int <format>_compress(in, n, out,
  cap)``, the frozen encoder that makes a read cell's streams and,
  built with ``-DPORTBENCH_CONTROL``, which it honours, the write
  cells' control (``portbench.frozen``).

A later change adds a configuration, a cell, a metric or a format by
adding its files and its entries in ``BENCHMARK.json``; no file here
names one.
"""

from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCHMARK = os.path.join(os.path.dirname(ROOT), "BENCHMARK.json")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(path: str = BENCHMARK) -> dict:
    return _json(path)


def cell(name: str, root: str = ROOT) -> dict:
    return _json(os.path.join(root, "cells", f"{name}.json"))


def config(name: str, root: str = ROOT) -> dict:
    return _json(os.path.join(root, "configs", f"{name}.json"))


def reader_path(metric: str, root: str = ROOT) -> str:
    """The reader's file of ``metric``; raises FileNotFoundError."""
    for stem in (metric, metric.split(".")[0]):
        path = os.path.join(root, "metrics", f"{stem}.py")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no reader for metric {metric!r} under "
                            f"{os.path.join(root, 'metrics')}")


def reader(metric: str, root: str = ROOT):
    """The ``read(ctx)`` function of ``metric``'s reader."""
    path = reader_path(metric, root)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, workload: str) -> tuple[list, list]:
    """The end-to-end and the per-layer metric entries ``workload``
    reports: those that list it under ``workloads``, or list none."""
    def mine(m):
        return workload in m.get("workloads", [workload])
    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")

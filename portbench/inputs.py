"""A cell's inputs, made from the seed: data of the configuration's mix,
and for a read cell the streams the frozen encoder makes of it.

This module imports no torch and nothing of the code under test, so the
inputs can be made in helper processes beside the one that drives the
card.
"""

from __future__ import annotations

import numpy as np

from . import frozen
from .data import gen
from .spec import ROOT

WRITES = ("compress", "compress_batch")
READS = ("decompress", "decompress_batch")


def _cut(data: bytes, lens) -> list:
    ends = np.cumsum(lens)
    return [data[e - n:e] for e, n in zip(ends.tolist(), lens.tolist())]


def make(config: dict, cell: dict, seed: int, k: int,
         root: str = ROOT) -> dict:
    """Input ``k`` of the cell's pool.

    ``arg``: what the API call takes (bytes, or a list of unit bytes, or
    for ``decompress_batch`` the unit streams and their lengths).
    ``expect``: what a read call must return.  ``units`` / ``streams``:
    the data's units and, for reads, the stream of each unit the call
    carries, from the frozen encoder of the configuration's format under
    ``root``.  ``decoded`` / ``encoded``: the call's bytes
    on each side (a write's ``encoded`` is known only from its output).

    A read carries the units that the deployment stores compressed: a
    unit whose stream does not save ``config["stored_raw_unless_saves"]``
    bytes is stored raw, and no decoder sees it.
    """
    rng = gen.rng_for(seed, k)
    call, api = cell["call"], cell["api"]
    if "units" in call:
        lens = gen.unit_lengths(call["units"], rng)
    else:
        lens = np.full(call["file_bytes"] // config["unit_bytes"],
                       config["unit_bytes"], np.int64)
    total = int(lens.sum())
    page = config["mix"]["page"]
    data = gen.make(config["mix"], -(-total // page) * page, rng)[:total]
    data = data.tobytes()
    units = _cut(data, lens)
    if api in WRITES:
        arg = data if api == "compress" else units
        return {"arg": arg, "units": units, "decoded": total}
    if api not in READS:
        raise ValueError(f"unknown API entry {api!r}")
    streams = [frozen.compress(config["format"], u, root=root)
               for u in units]
    keep = [len(s) + config["stored_raw_unless_saves"] <= len(u)
            for s, u in zip(streams, units)]
    units = [u for u, kp in zip(units, keep) if kp]
    streams = [s for s, kp in zip(streams, keep) if kp]
    if api == "decompress":
        arg, expect = b"".join(streams), b"".join(units)
    else:
        arg, expect = (streams, [len(u) for u in units]), units
    return {"arg": arg, "expect": expect, "units": units, "streams": streams,
            "decoded": sum(map(len, units)),
            "encoded": sum(map(len, streams))}

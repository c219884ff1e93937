"""Every pool input of every cell file, for seed 1, is the same bytes as
when its hashes were pinned (``data/pinned_inputs.json``): each input's
data, units and API argument, a read's streams and expected output, and
the write cells' control streams.  A change to how the harness finds a
format's frozen encoder or reference moves none of them."""

import hashlib
import json
import os

import pytest

from portbench import control, inputs, spec

with open(os.path.join(os.path.dirname(__file__), "data",
                       "pinned_inputs.json")) as f:
    PINNED = json.load(f)


def _feed(h, v):
    if isinstance(v, (bytes, bytearray)):
        h.update(b"b" + len(v).to_bytes(8, "little"))
        h.update(v)
    elif isinstance(v, (list, tuple)):
        h.update(b"l" + len(v).to_bytes(8, "little"))
        for e in v:
            _feed(h, e)
    elif isinstance(v, int):
        h.update(b"i" + str(v).encode() + b";")
    else:
        raise TypeError(type(v))


def digest(v) -> str:
    """sha256 of bytes, whole numbers and nested lists of them, each
    tagged with its kind and length."""
    h = hashlib.sha256()
    _feed(h, v)
    return h.hexdigest()


@pytest.mark.parametrize("name,k", [(n, k) for n in sorted(PINNED["cells"])
                                    for k in range(len(PINNED["cells"][n]))])
def test_a_pool_input_is_the_pinned_bytes(name, k):
    cell = spec.cell(name)
    config = spec.config(cell["config"])
    x = inputs.make(config, cell, PINNED["seed"], k)
    got = {key: digest(v) for key, v in x.items()}
    if cell["api"] in inputs.WRITES:
        got["control"] = digest(control.control_output(config, cell, x))
    assert got == PINNED["cells"][name][k]


def test_every_cell_file_is_pinned():
    names = {f[:-len(".json")] for f in os.listdir(
        os.path.join(spec.ROOT, "cells")) if f.endswith(".json")}
    assert set(PINNED["cells"]) <= names
    for name in PINNED["cells"]:
        assert len(PINNED["cells"][name]) == spec.cell(name)["pool"]

"""The plain LZXPRESS deployment, hiberfil7-xpress: its reference and
frozen encoder found by the format's name, the reference reading a whole
pool input of its read cell, the sets stored raw left out, and its
configuration and cell loading as every other does."""

import numpy as np
import pytest

from portbench import frozen, inputs, ref, spec
from portbench.data import gen

CELL = "hiberfil7-xpress.read"
BENCH = spec.benchmark()


def _data(kind, n, seed=3):
    return gen.KINDS[kind](gen.rng_for(seed), n).tobytes()


@pytest.mark.parametrize("control", [False, True])
def test_found_by_the_formats_name(control):
    assert ref.module("xpress").decode_units is ref.xpress.decode_units
    units = [_data("text", 8192, s) for s in range(2)] + [_data("zero", 100)]
    streams = [frozen.compress("xpress", u, control=control) for u in units]
    assert all(0 < len(s) < len(u) for s, u in zip(streams, units))
    got = ref.decode("xpress", streams, [len(u) for u in units])
    if control:
        # a finder that trusts its hash: text pages make wrong matches
        assert got != units
    else:
        assert got == units


@pytest.mark.parametrize("kind", sorted(gen.KINDS))
def test_reads_back_the_frozen_stream_of_every_kind(kind):
    units = [_data(kind, 4096, s) for s in range(2)] + [_data(kind, 77)]
    streams = [frozen.compress("xpress", u) for u in units]
    assert ref.decode("xpress", streams, [len(u) for u in units]) == units


def test_reads_every_set_of_a_pool_input():
    cell = spec.cell(CELL)
    config = spec.config(cell["config"])
    x = inputs.make(config, cell, 1, 0)
    streams, lens = x["arg"]
    assert len(streams) == len(x["units"]) > 480
    assert ref.decode("xpress", streams, lens) == x["expect"] == x["units"]


def test_sets_that_save_nothing_are_left_out():
    cell = dict(spec.cell(CELL), call={"units": {
        "count": 24, "bytes": 16384, "short": [4096, 8192]}})
    config = spec.config(cell["config"])
    seed, k = 2, 1
    x = inputs.make(config, cell, seed, k)
    # the same data, made as inputs.make makes it, set by set
    rng = gen.rng_for(seed, k)
    lens = gen.unit_lengths(cell["call"]["units"], rng)
    data = gen.make(config["mix"], int(lens.sum()), rng).tobytes()
    ends = np.cumsum(lens).tolist()
    sets = [data[e - n:e] for e, n in zip(ends, lens.tolist())]
    saved = [u for u in sets if len(frozen.compress("xpress", u)) < len(u)]
    assert x["units"] == saved and 0 < len(saved) <= len(sets)
    assert x["decoded"] == sum(map(len, saved))
    assert x["encoded"] == sum(map(len, x["streams"]))
    # pages that save nothing are stored raw, all of them
    rand = dict(config, mix=dict(config["mix"], shares={"random": 1.0}))
    assert inputs.make(rand, cell, seed, k)["units"] == []


def test_the_config_and_the_cell_load_and_name_what_exists():
    cell = spec.cell(CELL)
    config = spec.config(cell["config"])
    work = spec.workload(BENCH, CELL)
    entry = next(c for c in BENCH["configs"] if c["name"] == config["name"])
    assert (work["config"], work["why"], work["chips"]) == (
        cell["config"], cell["why"], 1)
    assert entry["file"] == f"portbench/configs/{config['name']}.json"
    assert entry["source"] == config["source"]
    assert entry["reduced"] == config["reduced"] == []
    assert config["format"] == "xpress"
    assert config["unit_bytes"] == config["page_bytes"] * config["set_pages"]
    assert set(config["guarantees"]) == {"lossless", "bit_exact_decode",
                                         "standalone_units"}
    assert cell["api"] == "decompress_batch" and cell["clients"] == 1
    assert cell["call"]["units"]["short"] == spec.cell(
        "hiberfil-xh.read")["call"]["units"]["short"]
    e2e, layer = spec.cell_metrics(BENCH, CELL)
    assert {m["name"] for m in e2e} == {"decode_GBps", "read_p95_ms",
                                        "setup_s"}
    assert {m["name"] for m in layer} == {
        f"{m}.read" for m in (
            "copy_ms_per_call", "device_roofline", "launches_per_call",
            "device_idle_pct", "staging_ms_per_call", "launch_ms_per_call",
            "sync_wait_ms_per_call", "syncs_per_call", "copy_GBps")}
    for m in e2e + layer:
        spec.reader(m["name"])

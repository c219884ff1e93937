"""The seeded generators: the same seed gives the same inputs; seeds and
pool inputs differ; every seed holds the same pages of each kind."""

import numpy as np
import pytest

from portbench import inputs, spec
from portbench.data import gen

MIX = spec.config("hiberfil-xh")["mix"]


@pytest.mark.parametrize("kind", sorted(gen.KINDS))
def test_kind_repeats_by_seed_and_differs_across_seeds(kind):
    a = gen.KINDS[kind](gen.rng_for(5, 0), 1 << 16)
    b = gen.KINDS[kind](gen.rng_for(5, 0), 1 << 16)
    assert a.dtype == np.uint8 and len(a) == 1 << 16
    assert np.array_equal(a, b)
    if kind != "zero":
        assert not np.array_equal(a, gen.KINDS[kind](gen.rng_for(6, 0),
                                                     1 << 16))


def test_large_seeds_of_any_sign():
    for seed in (0, 2**31 + 17, 2**40, -3):
        gen.rng_for(seed, 1).integers(0, 9, 4)


def test_every_seed_has_the_same_pages_of_each_kind():
    counts = [np.bincount(gen.page_kinds(MIX, 512, gen.rng_for(s)),
                          minlength=len(MIX["shares"])) for s in range(4)]
    assert all(np.array_equal(c, counts[0]) for c in counts)
    names = sorted(MIX["shares"])
    for name, c in zip(names, counts[0]):
        assert abs(c - MIX["shares"][name] * 512) <= 1


@pytest.mark.parametrize("name", ["ntfs-lznt1.read", "hiberfil-xh.write"])
def test_pool_inputs_repeat_by_seed_and_differ(name):
    cell = spec.cell(name)
    config = spec.config(cell["config"])
    small = dict(cell, call={"file_bytes": 4 * 65536}
                 if "file_bytes" in cell["call"] else
                 {"units": {"count": 6, "bytes": 65536, "short": [4096]}})
    a = inputs.make(config, small, 9, 0)
    assert inputs.make(config, small, 9, 0)["units"] == a["units"]
    assert inputs.make(config, small, 9, 1)["units"] != a["units"]
    assert inputs.make(config, small, 10, 0)["units"] != a["units"]


def test_unit_lengths_hold_the_short_units():
    units = {"count": 10, "bytes": 65536, "short": [4096, 8192]}
    lens = gen.unit_lengths(units, gen.rng_for(1))
    assert sorted(lens.tolist()) == [4096, 8192] + [65536] * 8

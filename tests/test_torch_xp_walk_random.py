"""The numpy model of ``csrc/xp_parse.cu`` (``test_torch_xp_walk.py``) at
the full unit width of 64 KiB: a unit of random bytes written as flag
words of 32 literals (2,048 of them, the walk's longest chain of flag
words), a unit of zeros and a mixed unit, both by the native C encoder.
The model against the plain parse slot for slot (about 50 s: the plain
parse loops once per payload byte of the longest stream) and against
tpucomp's Pallas parse in interpret mode and its XLA scan.  Exact
equality: every value is an integer.
"""

import random

import numpy as np

from conftest import make_corpus
from test_torch_xp_walk import (hold_to_plain, hold_to_tpucomp, literals,
                                pack, walk_steps, write_stream)
from tpucomp import _native
from _threads import _one_thread  # noqa: F401

U = 1 << 16


def test_model_at_64_kib(monkeypatch):
    rand, _ = write_stream(literals(U, 20))
    mixed = make_corpus(random.Random(21), U)
    rows = [(rand, len(rand), U)] + [
        (s, len(s), U) for s in (_native.xpress_compress(bytes(U)),
                                 _native.xpress_compress(mixed))]
    payload, plen, olen = pack(rows)
    assert payload.shape[1] == -(-(U + 4 * U // 32) // 16) * 16
    got = hold_to_plain(payload, plen, olen, U)
    hold_to_tpucomp(payload, plen, olen, U, got, monkeypatch)
    steps = walk_steps(payload, plen, olen, U)
    assert steps[0] == U // 32 and got[2].tolist() == [U] * 3
    assert (got[3] == 0).all() and steps[1] < 64 < steps[2]

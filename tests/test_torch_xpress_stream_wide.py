"""tpucomp_torch's plain Xpress ``compress`` of more than 64 KiB (the
single-stream encoder at its default 64 KiB lanes) on the CPU against
tpucomp's ``compress``, byte for byte, each stream decoded back through
tpucomp's oracle and the native C decoder; the committed vector
``tests/data/xp_stream.bin``; and the match finder's two kernels' plain
versions at the stream's row width, 8192 + 65536 = 73,728, against
tpucomp's XLA forms.  tpucomp encodes every stream here in dispatches of
8 lanes (its ``pad_batch``), one compile shape.  Every value is a byte or
an integer: the tolerance is exact equality.
"""

import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucomp_torch
from benchmarks.corpus import _synthetic
from chip_smoke import XP_STREAM_INPUT_SHA256, XP_STREAM_SHA256
from chip_smoke import XP_STREAM_VECTOR
from tpucomp import _native
from tpucomp.codecs import xpress as t_xp
from tpucomp.kernels import common as t_common
from tpucomp.oracle import xpress as oracle
from tpucomp_torch.codecs import xpress as xp
from tpucomp_torch.config import DEFAULT
from tpucomp_torch.kernels import match, runs
from _threads import _one_thread  # noqa: F401

UNIT = xp.UNIT
WIDE = xp.WINDOW + UNIT  # a stream row: [8 KiB history | 64 KiB lane]
VECTOR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), XP_STREAM_VECTOR)


@pytest.fixture(autouse=True)
def _xla_mode(monkeypatch):
    # tpucomp's common.* take their XLA forms unless a Pallas mode is set
    for var in ("TPUCOMP_PALLAS", "TPUCOMP_RUNS_PALLAS",
                "TPUCOMP_SORT_PALLAS", "TPUCOMP_COMMIT_PALLAS"):
        monkeypatch.delenv(var, raising=False)


def vector_input() -> bytes:
    return _synthetic(3 * UNIT + 4321)


INPUTS = {
    "one_byte_over": lambda: _synthetic(UNIT + 1),
    "three_lanes": lambda: _synthetic(150001),
    # a lane of one byte value: one match of 65,535 bytes, the u16 escape
    "single_byte_lane": lambda: (_synthetic(UNIT) + b"q" * UNIT
                                 + _synthetic(1000)),
}


@pytest.mark.parametrize("name", list(INPUTS))
def test_compress_over_64k_matches_tpucomp(name):
    data = INPUTS[name]()
    got = tpucomp_torch.compress("xpress", data, device="cpu")
    assert got == t_xp.compress(data)
    assert oracle.decompress(got, len(data)) == data
    assert _native.xpress_decompress(got, len(data)) == data


def test_vector_is_tpucomps_stream():
    data = vector_input()
    assert hashlib.sha256(data).hexdigest() == XP_STREAM_INPUT_SHA256
    with open(VECTOR, "rb") as f:
        vec = f.read()
    assert hashlib.sha256(vec).hexdigest() == XP_STREAM_SHA256
    assert t_xp.compress_stream(data) == vec
    assert xp.compress_stream(data, device="cpu") == vec
    assert _native.xpress_decompress(vec, len(data)) == data


def stream_rows(n_rows, seed):
    """Rows of the stream's width: zeros then text (a lane after the
    stream's zero history), text, a run across the 64 KiB mark, random
    bytes, and periods 2 and 3 with a break."""
    r = np.random.default_rng(seed)
    text = np.frombuffer(_synthetic(WIDE), np.uint8)
    rows = np.zeros((5, WIDE), np.uint8)
    rows[0, xp.WINDOW:] = text[:UNIT]
    rows[1] = text
    rows[2, :] = text
    rows[2, 60000:70000] = 7
    rows[3] = r.integers(0, 256, WIDE)
    rows[4] = np.tile([1, 2, 3], WIDE // 3)
    rows[4, 40000] = 9
    return rows[:n_rows]


def test_run_matchlens_at_stream_width():
    x = stream_rows(5, seed=1)
    disps = tuple(DEFAULT.run_disps)
    got = runs.run_matchlens(torch.from_numpy(x), disps)
    want = t_common.run_matchlens(jnp.asarray(x, jnp.int32), disps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0][2, 60001]) == 9999  # a run across the 64 KiB mark


def test_hash_best_match_at_stream_width():
    x = stream_rows(3, seed=2)
    kw = dict(hash_bits=DEFAULT.hash_bits, num_cands=DEFAULT.num_candidates,
              cap=DEFAULT.cap, max_disp=xp.WINDOW)
    got = match.hash_best_match(torch.from_numpy(x), WIDE, **kw)
    want = t_common.hash_best_match(jnp.asarray(x, jnp.int32), WIDE, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ext = match.extend_saturated(*got, DEFAULT.cap, WIDE)
    np.testing.assert_array_equal(
        ext.numpy(), np.asarray(t_common.extend_saturated(*want, DEFAULT.cap,
                                                          WIDE)))
    assert int(ext.max()) > 1000  # saturated matches extended
    # 17 position bits: the key of the last position keeps its position
    key = match.hash_keys(torch.from_numpy(x), DEFAULT.hash_bits,
                          (WIDE - 1).bit_length())
    assert (WIDE - 1).bit_length() == 17
    np.testing.assert_array_equal((key & ((1 << 17) - 1))[:, -1].numpy(),
                                  [WIDE - 1] * 3)

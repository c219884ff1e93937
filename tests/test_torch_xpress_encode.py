"""tpucomp_torch's plain Xpress ``encode_batch``, in the plain PyTorch
versions of its kernels on the CPU, against tpucomp's ``_encode_impl``
(XLA, a fresh trace for each config) at the default ``MatchFinderConfig``
and with ``second_hash_cands = 2``, at unit widths 512, 4096 and 65536:
the stream bytes and lengths exactly, and each stream decoded back by the
oracle and by the port.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucomp.config
from conftest import make_corpus
from tpucomp.codecs import xpress as t_xp
from tpucomp.oracle import xpress as oracle
from tpucomp_torch.codecs import xpress as xp
from tpucomp_torch.config import MatchFinderConfig
from _threads import _one_thread  # noqa: F401


def _encode_units(W):
    """Units of width W: text, a long run (u16 escapes), periodic bytes,
    random bytes, zeros, a short unit and an empty one."""
    rng = random.Random(W + 1)
    r = np.random.default_rng(W + 1)
    return [make_corpus(rng, W), b"a" + b"b" * (W - 40) + b"cd" * 19,
            (bytes(r.integers(0, 256, 37, np.uint8)) * (W // 37 + 1))[:W],
            r.integers(0, 256, W, np.uint8).tobytes(), bytes(W),
            make_corpus(rng, 61), b""]


def _tpu_encode(units, W, match, monkeypatch):
    """tpucomp's ``_encode_impl`` (a fresh XLA trace) at ``match``."""
    monkeypatch.setattr(tpucomp.config.DEFAULT, "match",
                        tpucomp.config.MatchFinderConfig(**match.to_dict()))
    rows = np.zeros((len(units), W), np.int32)
    for i, u in enumerate(units):
        rows[i, :len(u)] = np.frombuffer(u, np.uint8)
    ulen = np.array([len(u) for u in units], np.int32)
    payload, plen = jax.jit(lambda a, b: t_xp._encode_impl(a, b, W))(
        jnp.asarray(rows), jnp.asarray(ulen))
    return rows.astype(np.uint8), ulen, np.asarray(payload), np.asarray(plen)


@pytest.mark.parametrize("second", [0, 2])
@pytest.mark.parametrize("W", [512, 4096, 65536])
def test_encode_batch_matches_tpucomp(W, second, monkeypatch):
    units = _encode_units(W)
    if W == 65536:  # one row: long periodic matches and a run
        units = [(units[3][:3000] * 22)[:W - 9000] + b"z" * 9000]
    match = MatchFinderConfig(second_hash_cands=second)
    rows, ulen, t_pay, t_plen = _tpu_encode(units, W, match, monkeypatch)
    payload, plen = xp.encode_batch(torch.from_numpy(rows),
                                    torch.from_numpy(ulen), match)
    np.testing.assert_array_equal(plen.numpy(), t_plen)
    np.testing.assert_array_equal(payload.numpy(), t_pay)
    streams = [payload[i, :plen[i]].numpy().tobytes()
               for i in range(len(units))]
    for s, u in zip(streams, units):
        assert len(s) <= xp.max_compressed_size(len(u))
        if u:
            assert oracle.decompress(s, len(u)) == u
    assert xp.decompress_units(streams, [len(u) for u in units], W,
                               device="cpu") == units

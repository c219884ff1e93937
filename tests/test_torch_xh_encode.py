"""tpucomp_torch's Xpress Huffman encode, in the plain PyTorch versions of
its kernels on the CPU, against tpucomp:

- ``huffman_code_lengths`` against tpucomp's under ``jax.jit`` (as
  ``_encode_impl`` runs it): random, skewed, tie-heavy, one-symbol and
  empty rows, and Fibonacci-like counts that need the 15-bit repair;
- ``histogram`` against ``histogram_matmul``;
- ``encode_batch`` against ``_encode_impl`` (XLA, a fresh trace for each
  config) at unit widths 512, 1000 and 4096, at the default
  ``MatchFinderConfig`` and with ``second_hash_cands = 2``: the stream
  bytes and lengths exactly, and each stream decoded back by the oracle
  and (at widths that are a multiple of 512) by the port.

``test_torch_xh_compress.py`` takes the 64 KiB rows and the public calls.

Every value is a byte or an integer, so the tolerance is exact equality.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucomp
import tpucomp.config
from conftest import make_corpus
from tpucomp.codecs import xpress_huff as t_xh
from tpucomp.kernels import huffman as t_huff
from tpucomp.kernels.common import histogram_matmul
from tpucomp.oracle import xpress_huff as oracle
from tpucomp_torch.codecs import xpress_huff as xh
from tpucomp_torch.config import MatchFinderConfig
from tpucomp_torch.kernels import common, huffman
from _threads import _one_thread  # noqa: F401

_t_lengths = jax.jit(t_huff.huffman_code_lengths)


def _freq_rows(kind, seed):
    """[8, 512] int32 symbol counts of one kind, from a seed."""
    r = np.random.default_rng(seed)
    rows = np.zeros((8, 512), np.int64)
    for i in range(8):
        if kind == "random":
            rows[i] = r.integers(0, 300, 512)
        elif kind == "skewed":
            rows[i] = r.zipf(1.2 + 0.1 * i, 512) % 60000
        elif kind == "ties":  # a handful of distinct counts, most symbols
            rows[i] = np.where(r.random(512) < 0.3 + 0.08 * i,
                               r.integers(1, 1 + i % 3 + 1, 512), 0)
        elif kind == "sparse":  # one symbol, two equal ones, empty rows
            if i % 3 == 0:
                rows[i, r.integers(512)] = r.integers(1, 65537)
            elif i % 3 == 1:
                rows[i, r.choice(512, 2, replace=False)] = 7
        else:  # Fibonacci counts: depths past 15 before the repair
            a, b = 1, 1
            for s in r.choice(512, 20 + i, replace=False):
                rows[i, s] = a
                a, b = b, a + b
    return rows.astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "skewed", "ties", "sparse",
                                  "fibonacci"])
def test_huffman_code_lengths_match_tpucomp(kind):
    for seed in range(3):
        freqs = _freq_rows(kind, seed)
        want = np.asarray(_t_lengths(jnp.asarray(freqs)))
        got = huffman.huffman_code_lengths(torch.from_numpy(freqs))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.max() <= 15
    if kind == "fibonacci":
        assert (want.max(axis=1) == 15).all()  # the repair bound every row


def test_histogram_matches_histogram_matmul():
    r = np.random.default_rng(5)
    sym = r.integers(-3, 520, (4, 3000)).astype(np.int32)
    sym[1] = 512  # the encoder's sentinel: nothing counted
    sym[2, :2500] = 65
    want = np.asarray(histogram_matmul(jnp.asarray(sym), 512))
    got = common.histogram(torch.from_numpy(sym), 512)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _encode_units(W):
    """Units of width W: text, a long run (u16 escapes), periodic and random
    bytes, zeros, a short text unit, three-symbol noise (tied counts), one
    byte repeated (one-symbol tables) and an empty unit."""
    rng = random.Random(W + 1)
    r = np.random.default_rng(W + 1)
    return [make_corpus(rng, W), b"a" + b"b" * (W - 40) + b"cd" * 19,
            (bytes(r.integers(0, 256, 37, np.uint8)) * (W // 37 + 1))[:W],
            r.integers(0, 256, W, np.uint8).tobytes(), bytes(W),
            make_corpus(rng, 61), r.integers(0, 3, W, np.uint8).tobytes(),
            b"q", b""]


def _tpu_encode(units, W, match, monkeypatch):
    """tpucomp's ``_encode_impl`` (a fresh XLA trace) at ``match``."""
    monkeypatch.setattr(tpucomp.config.DEFAULT, "match",
                        tpucomp.config.MatchFinderConfig(**match.to_dict()))
    rows = np.zeros((len(units), W), np.int32)
    for i, u in enumerate(units):
        rows[i, :len(u)] = np.frombuffer(u, np.uint8)
    ulen = np.array([len(u) for u in units], np.int32)
    payload, plen = jax.jit(lambda a, b: t_xh._encode_impl(a, b, W))(
        jnp.asarray(rows), jnp.asarray(ulen))
    return rows.astype(np.uint8), ulen, np.asarray(payload), np.asarray(plen)


def check_encode_batch(units, W, second, monkeypatch):
    """The port's ``encode_batch`` of ``units`` in [N, W] rows against
    tpucomp's, with ``second_hash_cands = second``; the streams decoded
    back by the oracle and, the short ones, by the port."""
    match = MatchFinderConfig(second_hash_cands=second)
    rows, ulen, t_pay, t_plen = _tpu_encode(units, W, match, monkeypatch)
    payload, plen = xh.encode_batch(torch.from_numpy(rows),
                                    torch.from_numpy(ulen), match)
    np.testing.assert_array_equal(plen.numpy(), t_plen)
    np.testing.assert_array_equal(payload.numpy(), t_pay)
    streams = [payload[i, :plen[i]].numpy().tobytes()
               for i in range(len(units))]
    for s, u in zip(streams, units):
        assert len(s) <= xh.max_compressed_size(len(u))
        assert oracle.decompress(s, len(u)) == u
    # the port's plain XH parse loops once per body byte: short units only
    short = [i for i, s in enumerate(streams) if len(s) < 2200]
    if W % 512 == 0 and second == 0 and short:
        assert xh.decompress_units([streams[i] for i in short],
                                   [len(units[i]) for i in short], W,
                                   device="cpu") == [units[i] for i in short]


@pytest.mark.parametrize("second", [0, 2])
@pytest.mark.parametrize("W", [512, 1000, 4096])
def test_encode_batch_matches_tpucomp(W, second, monkeypatch):
    check_encode_batch(_encode_units(W), W, second, monkeypatch)

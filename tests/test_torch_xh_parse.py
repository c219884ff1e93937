"""tpucomp_torch's Xpress Huffman tables and parse, in their plain
PyTorch versions on the CPU, against tpucomp's: the canonical tables, and
the parse's records filled (the slot layout is free), p_final and err on
every row, valid and malformed, at substep tiers 3, 5 and 17.

tpucomp's Pallas parse runs in interpret mode, as its own tests run it,
once per substep tier as its buckets make them.  The same seeded inputs go
through both packages as numpy arrays.  Every value is an integer, so the
tolerance is exact equality.
"""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_corpus
from tpucomp import _native
from tpucomp.codecs import xpress_huff as t_xh
from tpucomp.kernels import common as t_common
from tpucomp.kernels import huffman as t_huff
from tpucomp.kernels import xh_pallas
from tpucomp.oracle import xpress_huff as oracle
from tpucomp_torch.codecs import xpress_huff as xh
from tpucomp_torch.kernels import fill, huffman, xh_parse
from _threads import _one_thread  # noqa: F401

U = 16384


def _stream_rows():
    """(stream, out_len) rows of every kind, at U: native, oracle and
    random-bytes units, a zero unit, and malformed ones."""
    rng = random.Random(0xC0FFEE)
    r = np.random.default_rng(17)
    text = make_corpus(rng, U)
    short = make_corpus(rng, U - 3000)
    # seeded random bytes, every value equally often, so that no code is
    # shorter than 8 bits (substep tier 3); a short unit keeps the plain
    # parse's step loop short
    noise = np.concatenate([r.permutation(256) for _ in range(16)]).astype(
        np.uint8).tobytes()
    good = [(_native.xh_compress(text), U),
            (oracle.compress(short), len(short)),
            (_native.xh_compress(noise), len(noise)),  # tier 3
            (_native.xh_compress(bytes(U)), U)]  # tier 17
    s = good[0][0]
    flipped = bytearray(s)
    for k in r.choice(np.arange(300, len(s)), 4, replace=False):
        flipped[k] ^= 1 << int(r.integers(8))
    bad = [(s[:256 + (len(s) - 256) // 3], U),  # body cut short
           (bytes(flipped), U),
           (r.integers(0, 256, 256, dtype=np.uint8).tobytes()
            + s[256:1256], U),  # random code lengths
           (good[1][0], U),  # out_len past the content
           (s[:100], U),  # shorter than the table
           (r.integers(0, 256, 2200, dtype=np.uint8).tobytes(), 2000)]
    return good, bad


@functools.lru_cache(maxsize=None)
def _batch():
    """The numpy batch (payload, plen, out_len, ss) of every row, and how
    many rows are well-formed."""
    good, bad = _stream_rows()
    rows = good + bad
    P = max(len(s) for s, _ in rows)
    P = -(-P // 64) * 64 + 256
    payload = np.zeros((len(rows), P), np.int32)
    plen = np.zeros(len(rows), np.int32)
    olen = np.zeros(len(rows), np.int32)
    ss = np.zeros(len(rows), np.int32)
    for k, (s, o) in enumerate(rows):
        payload[k, :len(s)] = np.frombuffer(s, np.uint8)
        plen[k], olen[k] = len(s), o
        ss[k] = xh._substeps_for(xh._min_code_len([s]))
    return payload, plen, olen, ss, len(good)


def _lengths(payload):
    return np.array(t_xh._unpack_table(jnp.asarray(payload)))


def _tpu_tables(lengths):
    codes, fc, br, lim = (np.asarray(a) for a in t_huff.canonical_from_lengths(
        jnp.asarray(lengths)))
    sym = np.asarray(t_huff.rank_to_symbol_table(jnp.asarray(lengths)))
    return codes, fc, br, lim, sym


def _table_cases():
    r = np.random.default_rng(4)
    real = _lengths(_batch()[0])
    one = np.zeros((1, 512), np.int32)
    one[0, 300] = 1
    return {
        "real": real,
        "all_zero": np.zeros((2, 512), np.int32),
        "one_symbol": one,
        "oversubscribed": r.integers(0, 16, (3, 512)).astype(np.int32),
    }


@pytest.mark.parametrize("kind", ["real", "all_zero", "one_symbol",
                                  "oversubscribed"])
def test_tables_match_tpucomp(kind):
    lengths = _table_cases()[kind]
    codes, fc, br, lim, sym = _tpu_tables(lengths)
    lt = torch.from_numpy(lengths)
    got = huffman.canonical_from_lengths(lt)
    for g, w in zip(got, (codes, fc, br, lim)):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(huffman.rank_to_symbol_table(lt).numpy(),
                                  sym)
    # the parse kernel's prep (xh_pallas.parse_records:398-400)
    lim15, rbf = huffman.level_tables(*got[1:])
    lvl = np.arange(16)
    np.testing.assert_array_equal(lim15.numpy(), lim << (15 - lvl))
    np.testing.assert_array_equal(rbf.numpy(), br - fc)
    if kind == "real":
        assert (sym[:, 300:] == 0).any() and (codes > 0).any()


def test_unpack_table_matches_tpucomp():
    payload = _batch()[0]
    got = huffman.unpack_table(torch.from_numpy(payload.astype(np.uint8)))
    np.testing.assert_array_equal(got.numpy(), _lengths(payload))


@functools.lru_cache(maxsize=None)
def _port_parse():
    payload, plen, olen, ss, _ = _batch()
    return xh.parse_batch(*xh.batch_from_numpy(payload, plen, olen, ss,
                                               device="cpu"), U)


@functools.lru_cache(maxsize=None)
def _tpu_parse():
    """tpucomp's Pallas parse (interpret mode) of every row, one call per
    substep tier as its buckets make them: (rows, rec_pos, rec_val,
    p_final, err) per tier."""
    payload, plen, olen, ss, _ = _batch()
    lengths = _lengths(payload)
    _, fc, br, lim, sym = _tpu_tables(lengths)
    out = []
    for tier in sorted(set(ss.tolist())):
        rows = np.nonzero(ss == tier)[0]
        pb = max(64, -(-int(plen[rows].max() - 256) // 64) * 64)
        res = xh_pallas.parse_records(
            jnp.asarray(payload[rows, 256:256 + pb]),
            jnp.asarray(plen[rows] - 256), jnp.asarray(olen[rows]),
            jnp.asarray(fc[rows]), jnp.asarray(br[rows]),
            jnp.asarray(lim[rows]), jnp.asarray(sym[rows]), U, tier,
            interpret=True)
        out.append((rows, *(np.array(a) for a in res)))
    return out


def _tpu_fill(rec_pos, rec_val, keep=None):
    return [np.asarray(a) for a in t_common.fill_records_delta2(
        jnp.asarray(rec_pos), jnp.asarray(rec_val), U, keep=keep)]


def test_parse_matches_pallas():
    """Native, oracle, random-bytes and zero units and malformed rows in
    one port call with per-row substep tiers 3, 5 and 17, against
    tpucomp's parse per tier; records compare filled (the slot layout is
    free), p_final and err exactly, on every row."""
    payload, plen, olen, ss, n_good = _batch()
    assert {3, 5, 17} <= set(ss.tolist())
    rec_pos, rec_val, p_final, err = _port_parse()
    assert ((rec_pos == xh_parse.SENT) | (rec_pos < U)).all()
    for rows, t_pos, t_val, t_p, t_err in _tpu_parse():
        np.testing.assert_array_equal(p_final.numpy()[rows], t_p)
        np.testing.assert_array_equal(err.numpy()[rows], t_err)
        want = _tpu_fill(t_pos, t_val)
        got = fill.fill_records_delta2_ref(rec_pos[rows], rec_val[rows], U)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    ok = (err.numpy() == 0) & (p_final.numpy() >= olen)
    assert ok[:n_good].all() and (~ok[n_good:]).sum() >= 4


def test_fill_matches_tpucomp_on_pallas_records(monkeypatch):
    """tpucomp's own parse records, SENT gaps and all: R > U in the tier-17
    call (tpucomp's XLA form only), R <= U in the tier-5 one (its fused
    kernel too); and a keep that binds, where bytes compare on the rows
    that do not overflow."""
    tiers = {len(t[0]): t for t in _tpu_parse()}
    wide = max(tiers.values(), key=lambda t: t[1].shape[1])
    assert wide[1].shape[1] > U
    narrow = max(tiers.values(), key=lambda t: len(t[0]))
    assert narrow[1].shape[1] <= U
    for (_, t_pos, t_val, _, _), fused in ((wide, False), (narrow, True)):
        pos, val = torch.from_numpy(t_pos), torch.from_numpy(t_val)
        for keep in (None, 300):
            got = [g.numpy() for g in fill.fill_records_delta2_ref(
                pos, val, U, keep)]
            monkeypatch.delenv("TPUCOMP_FILL_PALLAS", raising=False)
            wants = [_tpu_fill(t_pos, t_val, keep)]
            if fused and keep:
                monkeypatch.setenv("TPUCOMP_FILL_PALLAS", "interpret")
                wants.append(_tpu_fill(t_pos, t_val, keep))
            for want in wants:
                np.testing.assert_array_equal(got[2], want[2])
                ok = want[2] == 0
                np.testing.assert_array_equal(got[0][ok], want[0][ok])
                np.testing.assert_array_equal(got[1][ok], want[1][ok])
            assert ok.any() and (keep is None or not ok.all())

"""tpucomp_torch Xpress Huffman batched decode on the CPU against tpucomp:
the whole decode_batch, ``decompress_units`` and the public
``decompress_batch``, the archive path, and their errors.

Every value is a byte or an integer, so the tolerance is exact equality.
Bytes of a row with err set are don't-cares in both packages, so those
rows compare err only.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest

import tpucomp
import tpucomp_torch
from conftest import make_corpus
from tpucomp import _native
from tpucomp.codecs import xpress_huff as t_xh
from tpucomp.oracle import xpress_huff as oracle
from tpucomp_torch.codecs import xpress_huff as xh
from _spans import totals, traced
from _threads import _one_thread  # noqa: F401

U = 16384


def _units(rng, n=3):
    """Short units (the plain parse loops once per body byte): text, a
    periodic run with a long-range repeat, and a unit of zeros."""
    text = make_corpus(rng, 6000)
    return [text, (b"abcabd" * 1500)[:8000] + text[:2500], bytes(U)][:n]


def _slice_batch():
    """Substep tier 5 rows, as one tpucomp bucket holds them: native and
    oracle units, and malformed ones (cut short, flipped bytes, out_len
    past the content)."""
    rng = random.Random(0xC0FFEE)
    units = _units(rng, 2) + [make_corpus(rng, 3000)]
    streams = [_native.xh_compress(units[0]), _native.xh_compress(units[1]),
               oracle.compress(units[2])]
    lens = [len(u) for u in units]
    s = bytearray(streams[0])
    s[700] ^= 0x10
    s[900] ^= 0x81
    streams += [streams[0][:256 + (len(streams[0]) - 256) // 2], bytes(s),
                streams[2]]
    lens += [lens[0], lens[0], lens[2] + 50]
    P = -(-max(len(x) for x in streams) // 64) * 64
    payload = np.zeros((len(streams), P), np.int32)
    for k, x in enumerate(streams):
        payload[k, :len(x)] = np.frombuffer(x, np.uint8)
    plen = np.array([len(x) for x in streams], np.int32)
    ss = np.array([xh._substeps_for(xh._min_code_len([x])) for x in streams],
                  np.int32)
    assert (ss == 5).all()
    return payload, plen, np.array(lens, np.int32), ss, units


def test_decode_batch_matches_tpucomp_interpret():
    """The port's decode_batch against tpucomp's unjitted _decode_impl in
    interpret mode (its Pallas parse and near walk): err on every row,
    bytes where err is 0."""
    payload, plen, olen, ss, units = _slice_batch()
    want_out, want_err = (np.asarray(a) for a in t_xh._decode_impl(
        jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(olen), U, 5,
        mode="interpret"))
    out, err = (t.numpy() for t in xh.decode_batch(
        *xh.batch_from_numpy(payload, plen, olen, ss, device="cpu"), U))
    assert out.dtype == np.uint8 and out.shape == (len(plen), U)
    np.testing.assert_array_equal(err, want_err)
    ok = ~err
    np.testing.assert_array_equal(out[ok], want_out[ok])
    assert ok[:3].all() and err[3:].sum() >= 2
    for k, u in enumerate(units):
        assert out[k, :len(u)].tobytes() == u


@pytest.mark.parametrize("unit_size", [U, 65536])
def test_decompress_batch_matches_tpucomp(unit_size):
    """The public call against tpucomp's (its default XLA path): at 16 KiB
    three units of every tier, at 64 KiB two units whose copies reach
    across 4 KiB segments."""
    rng = random.Random(7)
    if unit_size == U:
        units = _units(rng)
    else:
        text = make_corpus(rng, 8192)
        units = [text * 8, (b"xyz" * 30000)[:unit_size - 1000] + text[:1000]]
    streams = [_native.xh_compress(u) for u in units]
    lens = [len(u) for u in units]
    got = tpucomp_torch.decompress_batch("xpress_huff", streams, lens,
                                         unit_size=unit_size, device="cpu")
    assert got == units
    assert got == tpucomp.decompress_batch("xpress_huff", streams, lens,
                                           unit_size=unit_size)


@pytest.mark.parametrize("depth", [0, 2])
def test_fast_resolve_on_resolved_archive_units(depth):
    rng = random.Random(depth)
    units = _units(rng, 2)
    streams = [_native.xh_compress_resolved(u, max_depth=depth)
               for u in units]
    lens = [len(u) for u in units]
    got = xh.decompress_units(streams, lens, U, fast_resolve=True,
                              device="cpu")
    assert got == units
    assert got == t_xh.decompress_units(streams, lens, U, fast_resolve=True)


def test_errors_match_tpucomp():
    rng = random.Random(3)
    unit = make_corpus(rng, 2000)
    s = _native.xh_compress(unit)

    def both(streams, lens, unit_size=U):
        return (lambda: xh.decompress_units(streams, lens, unit_size,
                                            device="cpu"),
                lambda: t_xh.decompress_units(streams, lens, unit_size))

    for call in both([], []):
        assert call() == []
    for call in both([s, s], [0, len(unit)]):
        assert call() == [b"", unit]
    for call in both([s], [U + 1]):
        with pytest.raises((tpucomp.ArgError, tpucomp_torch.ArgError)):
            call()
    for call in both([s, s[:400]], [len(unit), len(unit)]):
        with pytest.raises((tpucomp.DataError, tpucomp_torch.DataError)):
            call()
    with pytest.raises(tpucomp_torch.ArgError, match="out_lens"):
        tpucomp_torch.decompress_batch("xpress_huff", [s], device="cpu")
    for size in (1000, 65536 + 512):
        with pytest.raises(tpucomp_torch.ArgError, match="unit_size"):
            tpucomp_torch.decompress_batch("xpress_huff", [s], [10],
                                           unit_size=size, device="cpu")


def test_one_shot_decompress_not_ported():
    """The one-shot ``decompress`` is ported now: a one-block stream
    decodes as tpucomp decodes it, with one batch decode."""
    s = _native.xh_compress(b"hello hello hello")
    got, records = traced(lambda: tpucomp_torch.decompress(
        "xpress_huff", s, 17, device="cpu"))
    assert got == t_xh.decompress(s, 17) == b"hello hello hello"
    assert totals(records)["xh.batch_decodes"] == 1

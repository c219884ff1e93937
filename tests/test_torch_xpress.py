"""tpucomp_torch's plain Xpress unit decode and encode, in the plain
PyTorch versions of its kernels on the CPU, against tpucomp.

Decode: ``decode_batch`` against tpucomp's decoder in XLA and interpret
mode at unit widths 512 and 4096 (tpucomp's Pallas resolve), 1000 (its
XLA ``resolve_copies``) and 20000 (``resolve_copies_wide``): err on every
row, bytes on the rows without err; well-formed units from tpucomp, the
oracle and the native C encoder, and malformed rows.  Then the public
calls, encode and decode, and their errors (``encode_batch`` itself:
``test_torch_xpress_encode.py``).  Every value is a byte or an integer,
so the tolerance is exact equality.
"""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest

import tpucomp
import tpucomp_torch
from conftest import make_corpus
from tpucomp import _native
from tpucomp.codecs import xpress as t_xp
from tpucomp.errors import DataError as TDataError
from tpucomp.oracle import xpress as oracle
from tpucomp_torch.codecs import xpress as xp
from _threads import _one_thread  # noqa: F401


def _decode_rows(W):
    """(stream, out_len) rows at unit width W: well-formed units of three
    encoders, then malformed ones.  Returns (rows, n_good)."""
    rng = random.Random(W)
    r = np.random.default_rng(W)
    text = make_corpus(rng, W)
    short = make_corpus(rng, W // 3)
    runs = (b"x" * (W // 2) + bytes(r.integers(0, 4, W // 2, np.uint8)))[:W]
    good = [(_native.xpress_compress(text), W),
            (oracle.compress(short), len(short)),
            (_native.xpress_compress(runs), W),
            (_native.xpress_compress(r.integers(0, 256, W // 4, np.uint8)
                                     .tobytes()), W // 4)]
    if W <= 4096:
        good.append((t_xp.compress_units([text], unit_size=W)[0], W))
    s = good[0][0]
    bad = [(s[:len(s) // 3], W),  # cut short
           # the first token a match of offset 2 at position 0
           (s[:3] + bytes([s[3] | 0x80, 8, 0]) + s[6:], W),
           (good[1][0], len(short) + 5),  # out_len past the content
           (r.integers(0, 256, 300, np.uint8).tobytes(), min(W, 900))]
    return good + bad, len(good)


@functools.lru_cache(maxsize=None)
def _decode_batch(W):
    rows, n_good = _decode_rows(W)
    P = -(-max(len(s) for s, _ in rows) // 128) * 128
    payload = np.zeros((len(rows), P), np.int32)
    plen = np.array([len(s) for s, _ in rows], np.int32)
    olen = np.array([o for _, o in rows], np.int32)
    for k, (s, _) in enumerate(rows):
        payload[k, :len(s)] = np.frombuffer(s, np.uint8)
    out, err = xp.decode_batch(*xp.batch_from_numpy(payload, plen, olen,
                                                    device="cpu"), W)
    return payload, plen, olen, n_good, out.numpy(), err.numpy()


@pytest.mark.parametrize("mode", [None, "interpret"])
@pytest.mark.parametrize("W", [512, 4096, 1000, 20000])
def test_decode_batch_matches_tpucomp(W, mode):
    payload, plen, olen, n_good, out, err = _decode_batch(W)
    t_out, t_err = (np.asarray(a) for a in t_xp.make_decoder(W, mode)(
        jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(olen)))
    np.testing.assert_array_equal(err, t_err)
    ok = ~err
    np.testing.assert_array_equal(out[ok], t_out[ok])
    assert ok[:n_good].all() and not ok[n_good:].any()
    rows, _ = _decode_rows(W)
    for k in range(n_good):
        s, o = rows[k]
        assert out[k, :o].tobytes() == oracle.decompress(s, o)


def test_decompress_units_and_oneshot_match_tpucomp():
    rows, n_good = _decode_rows(4096)
    streams, lens = zip(*rows[:n_good])
    got = xp.decompress_units(streams, lens, 4096, device="cpu")
    assert got == t_xp.decompress_units(list(streams), list(lens),
                                        unit_size=4096)
    for s, n in rows[:2]:
        assert tpucomp_torch.decompress("xpress", s, n, device="cpu") == \
            tpucomp.decompress("xpress", s, n, backend="tpu")
    # fast_resolve changes nothing on this path, as in tpucomp
    assert xp.decompress_units(streams, lens, 4096, fast_resolve=True,
                               device="cpu") == got


def test_api_batch_and_oneshot_match_tpucomp():
    rng = random.Random(9)
    units = [make_corpus(rng, 4096), b"", b"ab", make_corpus(rng, 1234)]
    got = tpucomp_torch.compress_batch("xpress", units, unit_size=4096,
                                       device="cpu")
    assert got == tpucomp.compress_batch("xpress", units, unit_size=4096)
    lens = [len(u) for u in units]
    assert tpucomp_torch.decompress_batch(
        "xpress", got, lens, unit_size=4096, device="cpu") == units
    for data in (b"abc" * 33, make_corpus(rng, 5000)):  # 4 and 16 KiB units
        s = tpucomp_torch.compress("xpress", data, device="cpu")
        assert s == tpucomp.compress("xpress", data, backend="tpu")
        assert tpucomp_torch.decompress("xpress", s, len(data),
                                        device="cpu") == data
    assert tpucomp_torch.compress("xpress", b"", device="cpu") == b""
    assert tpucomp_torch.decompress("xpress", b"", 0, device="cpu") == b""
    assert tpucomp_torch.decompress_batch("xpress", [], [],
                                          device="cpu") == []


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 65536, 1 << 20])
def test_max_compressed_size_matches_tpucomp(n):
    assert tpucomp_torch.max_compressed_size("xpress", n) == \
        tpucomp.max_compressed_size("xpress", n)


def test_errors():
    E = tpucomp_torch
    stream = tpucomp_torch.compress("xpress", b"hello hello", device="cpu")
    cases = [
        (E.ArgError, lambda: E.decompress("xpress", stream, device="cpu")),
        (E.ArgError, lambda: E.decompress_batch("xpress", [stream],
                                                device="cpu")),
        (E.ArgError, lambda: E.decompress_batch(
            "xpress", [stream], [600], unit_size=512, device="cpu")),
        (E.ArgError, lambda: E.compress_batch(
            "xpress", [bytes(513)], unit_size=512, device="cpu")),
        (E.ArgError, lambda: E.compress_batch(
            "xpress", [b"a"], unit_size=70000, device="cpu")),
        (E.DataError, lambda: E.decompress_batch(
            "xpress", [bytes(xp.max_payload(512) + 1)], [512],
            unit_size=512, device="cpu")),
        (E.DataError, lambda: E.decompress("xpress", stream[:5], 11,
                                           device="cpu")),
        (E.UnsupportedFormatError, lambda: E.decompress(
            "xpress", stream, 65537, device="cpu")),
        (E.ArgError, lambda: xp.compress_stream(b"abc", unit_size=4096,
                                                device="cpu")),
    ]
    for exc, call in cases:
        with pytest.raises(exc):
            call()
    # tpucomp's own answers to the same calls, where it raises a class of
    # its taxonomy (the over-long stream hits numpy's ValueError there)
    with pytest.raises(TDataError):
        t_xp.decompress_units([stream[:5]], [11], unit_size=4096)
    with pytest.raises(ValueError):
        t_xp.decompress_units([bytes(xp.max_payload(512) + 1)], [512],
                              unit_size=512)
    with pytest.raises(tpucomp.UnsupportedFormatError):
        tpucomp.decompress("xpress", stream, 65537, backend="tpu")

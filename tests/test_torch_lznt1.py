"""tpucomp_torch LZNT1 decode on the CPU against tpucomp and the oracle:
the whole decode_batch, the public calls and their errors, and the
package's independence from JAX.

Every value is a byte or an integer, so the tolerance is exact equality.
Bytes of a row with err set are don't-cares in both packages (they differ
by design where tpucomp clamps or zeroes), so those rows compare err and
out_len only.
"""

import os
import random
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucomp
import tpucomp_torch
from conftest import make_corpus
from tpucomp import _native
from tpucomp.codecs import lznt1 as t_lz
from tpucomp.codecs.lznt1_expose import decode_batch_impl
from tpucomp.oracle import lznt1 as oracle
from tpucomp_torch.codecs import lznt1 as lz
from _threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _slice_batch():
    """12 chunks: oracle and native streams, stored-raw chunks and
    malformed ones (disp > pos, cut mid-token, random bytes)."""
    rng = random.Random(0xC0FFEE)
    data = make_corpus(rng, 3 * 4096 + 777)
    noise = bytes(rng.randrange(256) for _ in range(4096 + 300))
    chunks = []
    for stream in (oracle.compress(data), _native.lznt1_compress(noise),
                   _native.lznt1_compress(b"ab" * 2500)):
        payloads, comps = t_lz.split_stream(stream)
        chunks += list(zip(payloads, comps))
    chunks += [(bytes([0x01, 0x00, 0x00]), True),
               (chunks[0][0][:1000], True),
               (bytes(random.Random(5).randrange(256) for _ in range(900)),
                True)]
    N = 16
    payload = np.zeros((N, lz.PAYLOAD_PAD), np.int32)
    plen = np.zeros(N, np.int32)
    is_comp = np.zeros(N, bool)
    for k, (pl, cp) in enumerate(chunks):
        payload[k, :len(pl)] = np.frombuffer(pl, np.uint8)
        plen[k] = len(pl)
        is_comp[k] = cp
    return payload, plen, is_comp


@pytest.mark.parametrize("mode", ["interpret", "xla"])
def test_decode_batch_matches_tpucomp(mode, monkeypatch):
    # the unjitted impl reads its kernel mode on every call
    if mode == "interpret":
        monkeypatch.setenv("TPUCOMP_PALLAS", "interpret")
    else:
        monkeypatch.delenv("TPUCOMP_PALLAS", raising=False)
    payload, plen, is_comp = _slice_batch()
    want_out, want_len, want_err = (np.asarray(a) for a in decode_batch_impl(
        jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(is_comp)))
    out, out_len, err = (t.numpy() for t in lz.decode_batch(
        *lz.batch_from_numpy(payload, plen, is_comp, device="cpu")))
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(err, want_err)
    np.testing.assert_array_equal(out_len, want_len)
    ok = ~err
    np.testing.assert_array_equal(out[ok], want_out[ok])
    assert err.sum() >= 2 and ok[:12].sum() >= 9
    assert (plen[ok & ~is_comp] > 0).any()  # a stored-raw chunk decoded


def _cases(rng):
    corpus = make_corpus(rng, 20000)
    return [
        b"x",
        b"abc" * 50,
        b"a" * 10000,
        bytes(range(256)) * 16,  # late-position token splits
        corpus,
        bytes(rng.randrange(256) for _ in range(5000)),  # stored raw
    ]


@pytest.mark.parametrize("encoder", ["oracle", "native"])
def test_decompress_matches_tpucomp_and_oracle(encoder):
    compress = oracle.compress if encoder == "oracle" else _native.lznt1_compress
    for data in _cases(random.Random(1)):
        stream = compress(data)
        got = tpucomp_torch.decompress("lznt1", stream, device="cpu")
        assert got == data
        assert got == tpucomp.decompress("lznt1", stream, backend="tpu")
        assert got == oracle.decompress(stream)


def test_decompress_edges():
    data = make_corpus(random.Random(2), 9000)
    stream = oracle.compress(data, emit_terminator=True)
    assert tpucomp_torch.decompress("lznt1", b"", device="cpu") == b""
    assert tpucomp_torch.decompress(tpucomp_torch.Format.DEFAULT, stream,
                                    device="cpu") == data
    assert tpucomp_torch.decompress("lznt1", stream, 5000,
                                    device="cpu") == data[:5000]
    with pytest.raises(tpucomp_torch.DataError):
        tpucomp_torch.decompress("lznt1", stream, 9001, device="cpu")
    with pytest.raises(tpucomp.DataError):
        tpucomp.decompress("lznt1", stream, 9001, backend="tpu")
    with pytest.raises(tpucomp_torch.ArgError):
        tpucomp_torch.decompress("lznt1", None, device="cpu")


@pytest.mark.parametrize("stream", [
    bytes([0x02, 0xB0, 0x01, 0x00, 0x00]),  # copy at p=0: disp 1 > 0
    bytes([0xFF, 0xB0, 0x00]),  # payload past the end of the input
    bytes([0x01, 0xB0, 0x01, 0x07]),  # ends after a copy's lo byte
], ids=["disp_past_start", "past_input_end", "ends_mid_token"])
def test_malformed_raises_like_tpucomp(stream):
    with pytest.raises(tpucomp.DataError):
        tpucomp.decompress("lznt1", stream, backend="tpu")
    with pytest.raises(tpucomp_torch.DataError):
        tpucomp_torch.decompress("lznt1", stream, device="cpu")
    with pytest.raises(tpucomp.ArgError):
        tpucomp.decompress_batch("lznt1", [stream], None)
    with pytest.raises(tpucomp_torch.ArgError):
        tpucomp_torch.decompress_batch("lznt1", [stream], device="cpu")


def test_decompress_batch_matches_tpucomp():
    rng = random.Random(3)
    units = [make_corpus(rng, 9000), b"", bytes(rng.randrange(256)
                                                for _ in range(4500)),
             b"z" * 4096, make_corpus(rng, 100)]
    streams = [_native.lznt1_compress(u) for u in units]
    streams[3] = oracle.compress(units[3], emit_terminator=True)
    got = tpucomp_torch.decompress_batch("lznt1", streams, device="cpu")
    assert got == units
    assert got == tpucomp.decompress_batch("lznt1", streams, None)
    assert tpucomp_torch.decompress_batch("lznt1", [b"", b""],
                                          device="cpu") == [b"", b""]


@pytest.mark.parametrize("fmt", ["xpress", "xpress_huff",
                                 tpucomp_torch.Format.LZX])
def test_unported_formats_raise(fmt):
    """Every call of an unported format raises; of XPRESS and XPRESS_HUFF
    none does: every call is ported.  XPRESS_HUFF's one-shot
    ``decompress`` of a stream shorter than a table, and XPRESS's of a
    stream too short for its output, raise ``DataError``, as tpucomp's
    do; XPRESS's ``compress`` of more than 64 KiB gives one stream that
    decodes back."""
    calls = [lambda: tpucomp_torch.decompress(fmt, b"ab", 2, device="cpu")]
    if fmt == "xpress_huff":
        with pytest.raises(tpucomp.DataError):
            tpucomp.decompress(fmt, b"ab", 2, backend="tpu")
        with pytest.raises(tpucomp_torch.DataError, match="stream ended"):
            calls[0]()
        s = _native.xh_compress(b"hello hello hello")
        assert tpucomp_torch.decompress(fmt, s, 17, device="cpu") \
            == b"hello hello hello"
        return
    if fmt == "xpress":
        with pytest.raises(tpucomp.DataError):
            tpucomp.decompress(fmt, b"ab", 2, backend="tpu")
        with pytest.raises(tpucomp_torch.DataError, match="malformed"):
            calls[0]()
        s = tpucomp_torch.compress(fmt, bytes(65537), device="cpu")
        assert _native.xpress_decompress(s, 65537) == bytes(65537)
        return
    calls += [lambda: tpucomp_torch.compress(fmt, b"ab", device="cpu"),
              lambda: tpucomp_torch.compress_batch(fmt, [b"ab"], device="cpu"),
              lambda: tpucomp_torch.decompress_batch(fmt, [b"ab"], [2],
                                                     device="cpu")]
    for call in calls:
        with pytest.raises(tpucomp_torch.UnsupportedFormatError,
                           match="not ported"):
            call()


def test_unknown_format_raises_like_tpucomp():
    with pytest.raises(tpucomp.UnsupportedFormatError):
        tpucomp.decompress("bogus", b"ab")
    with pytest.raises(tpucomp_torch.UnsupportedFormatError):
        tpucomp_torch.decompress("bogus", b"ab", device="cpu")


def test_cuda_requested_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stream = oracle.compress(b"hello hello hello")
    for call in (lambda: tpucomp_torch.decompress("lznt1", stream),
                 lambda: tpucomp_torch.decompress_batch("lznt1", [stream]),
                 lambda: lz.batch_from_numpy(*_slice_batch())):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_import_loads_no_jax():
    code = ("import sys; before = set(sys.modules); import tpucomp_torch; "
            "print(sorted(m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'tpucomp')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_sources_import_neither_jax_nor_tpucomp():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|tpucomp)\b(?!_torch)",
                         re.M)
    root = os.path.join(REPO, "tpucomp_torch")
    build = os.path.join(root, "_build")  # build outputs, not sources
    files = [os.path.join(d, f) for d, _, fs in os.walk(root)
             if not d.startswith(build) for f in fs if f.endswith(".py")]
    assert len(files) >= 10
    for path in files + [os.path.join(REPO, "chip_smoke.py")]:
        with open(path) as f:
            assert not pattern.search(f.read()), path

"""tpucomp_torch LZNT1 encode on the CPU against tpucomp: the payloads of
``encode_batch`` at tpucomp's default and at other match-finder configs,
in tpucomp's XLA mode and with its Pallas kernels in interpret mode; the
public ``compress``, ``compress_batch`` and ``max_compressed_size``; and
every stream decoded back by the oracle and by the port.

Every value is a byte or an integer, so the tolerance is exact equality.
tpucomp's ``encode_batch`` reads its config and its Pallas mode when it
is traced, so each comparison traces it afresh and puts tpucomp's
default config back.
"""

import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

import tpucomp
import tpucomp_torch
from conftest import make_corpus
from tpucomp import config as t_config
from tpucomp.codecs import lznt1 as t_lz
from tpucomp.oracle import lznt1 as oracle
from tpucomp_torch import config
from tpucomp_torch.codecs import lznt1 as lz
from _threads import _one_thread  # noqa: F401

CHUNK = lz.CHUNK


def _chunk_batch():
    """Rows of every kind the encoder meets, each with its length: corpus
    text, zeros, random bytes (stored raw), periodic rows, a run longer
    than the compare cap, and short chunks of 0, 1, 2, 3 and 4095 bytes."""
    rng = random.Random(0xE11C)
    r = np.random.default_rng(5)
    text = make_corpus(rng, 3 * CHUNK)
    rows = [text[:CHUNK], text[CHUNK:2 * CHUNK], bytes(CHUNK),
            r.integers(0, 256, CHUNK, dtype=np.uint8).tobytes(),
            (b"ab" * CHUNK)[:CHUNK], (b"xyz" * CHUNK)[:CHUNK],
            text[:500] + b"q" * 3000 + text[500:1096],
            (text[:64] * 70)[:CHUNK],
            b"", b"a", b"ab", b"abc", text[2 * CHUNK:3 * CHUNK - 1],
            text[7:1007] * 2]
    chunks = np.zeros((len(rows), CHUNK), np.uint8)
    clen = np.zeros(len(rows), np.int32)
    for k, row in enumerate(rows):
        chunks[k, :len(row)] = np.frombuffer(row, np.uint8)
        clen[k] = len(row)
    return chunks, clen


def _tpucomp_encode(chunks, clen, match_dict=None):
    """tpucomp's encode_batch, traced afresh at its current Pallas mode
    and at ``match_dict`` (its default when None)."""
    saved = t_config.DEFAULT.match
    if match_dict is not None:
        d = dict(match_dict, run_disps=tuple(match_dict["run_disps"]))
        t_config.DEFAULT.match = t_config.MatchFinderConfig(**d)
    try:
        # a new function object: jax.jit of the same one reuses its trace
        fn = jax.jit(lambda c, n: t_lz.encode_batch.__wrapped__(c, n))
        payload, plen = fn(chunks.astype(np.int32), clen)
        return np.asarray(payload), np.asarray(plen)
    finally:
        t_config.DEFAULT.match = saved


def _port_encode(chunks, clen, match=None):
    payload, plen = lz.encode_batch(torch.from_numpy(chunks),
                                    torch.from_numpy(clen), match)
    assert payload.dtype == torch.uint8 and plen.dtype == torch.int32
    return payload.numpy(), plen.numpy()


def _assert_streams_decode(chunks, clen, payload, plen):
    for k in range(len(clen)):
        if 0 < plen[k] < clen[k]:
            hdr = (0xB000 | (int(plen[k]) - 1)).to_bytes(2, "little")
            body = payload[k, :plen[k]].tobytes()
            assert oracle.decompress(hdr + body) == chunks[k, :clen[k]].tobytes()


@pytest.mark.parametrize("mode", ["xla", "interpret"])
def test_encode_batch_matches_tpucomp(mode, monkeypatch):
    if mode == "interpret":
        monkeypatch.setenv("TPUCOMP_PALLAS", "interpret")
    else:
        monkeypatch.delenv("TPUCOMP_PALLAS", raising=False)
    chunks, clen = _chunk_batch()
    want_payload, want_plen = _tpucomp_encode(chunks, clen)
    payload, plen = _port_encode(chunks, clen)
    np.testing.assert_array_equal(plen, want_plen)
    np.testing.assert_array_equal(payload, want_payload)
    assert plen[8] == 0 and (plen[3] >= clen[3]) and (plen[2] < 100)
    _assert_streams_decode(chunks, clen, payload, plen)


@pytest.mark.parametrize("fields", [
    dict(num_candidates=0, cap=16, run_disps=[1]),
    dict(hash_bits=11, num_candidates=2, cap=16, run_disps=[2, 3]),
    dict(hash_bits=15, num_candidates=5, cap=8, run_disps=[]),
], ids=["runs_only", "narrow", "no_runs"])
def test_encode_batch_matches_tpucomp_at_other_configs(fields, monkeypatch):
    monkeypatch.delenv("TPUCOMP_PALLAS", raising=False)
    match = config.match_config_from_dict(fields)
    d = match.to_dict()
    assert d == dict(config.DEFAULT.to_dict(), **fields)
    chunks, clen = _chunk_batch()
    want_payload, want_plen = _tpucomp_encode(chunks, clen, d)
    payload, plen = _port_encode(chunks, clen, match)
    np.testing.assert_array_equal(plen, want_plen)
    np.testing.assert_array_equal(payload, want_payload)
    _assert_streams_decode(chunks, clen, payload, plen)


def test_config_defaults_equal_tpucomps():
    want = dataclasses.asdict(t_config.MatchFinderConfig())
    want["run_disps"] = list(want["run_disps"])
    assert config.DEFAULT.to_dict() == want
    assert dataclasses.asdict(t_config.DEFAULT.match)["cap"] == config.DEFAULT.cap
    assert config.match_config_from_dict({}) == config.DEFAULT
    with pytest.raises(ValueError, match="unknown"):
        config.match_config_from_dict({"window": 3})


def _inputs():
    rng = random.Random(9)
    text = make_corpus(rng, 3 * CHUNK + 123)
    return [text, text[:2 * CHUNK],  # a multiple of the chunk size
            bytes(rng.randrange(256) for _ in range(CHUNK + 5)) + bytes(100),
            b"z" * 9000, b"q", b"abc" * 10]


def test_compress_matches_tpucomp_and_round_trips(monkeypatch):
    monkeypatch.delenv("TPUCOMP_PALLAS", raising=False)
    for data in _inputs():
        got = tpucomp_torch.compress("lznt1", data, device="cpu")
        assert got == tpucomp.compress("lznt1", data, backend="tpu")
        assert len(got) <= tpucomp_torch.max_compressed_size("lznt1", len(data))
        assert oracle.decompress(got) == data
        assert tpucomp_torch.decompress("lznt1", got, device="cpu") == data
    assert tpucomp_torch.compress("lznt1", b"", device="cpu") == b""
    assert tpucomp_torch.compress(tpucomp_torch.Format.DEFAULT, b"abcabc",
                                  device="cpu") == \
        tpucomp.compress("lznt1", b"abcabc", backend="tpu")


def test_compress_batch_matches_tpucomp_and_round_trips(monkeypatch):
    monkeypatch.delenv("TPUCOMP_PALLAS", raising=False)
    rng = random.Random(10)
    text = make_corpus(rng, 4 * CHUNK)
    units = [text[:CHUNK], text[CHUNK:CHUNK + 700], b"x" * CHUNK, b"a",
             bytes(rng.randrange(256) for _ in range(2000)), text[5:4100]]
    got = tpucomp_torch.compress_batch("lznt1", units, device="cpu")
    assert got == tpucomp.compress_batch("lznt1", units)
    for u, s in zip(units, got):
        assert oracle.decompress(s) == u
    assert tpucomp_torch.decompress_batch("lznt1", got, device="cpu") == units
    # one unit, one chunk: the same bytes as the one-shot's chunk
    one = tpucomp_torch.compress("lznt1", text[:CHUNK], device="cpu")
    assert got[0] == one


def test_compress_batch_empty_and_oversize_units():
    """An empty unit gives b"" (as compress(b"") does) and a unit over
    4096 bytes raises ArgError; tpucomp raises OverflowError and numpy's
    ValueError there (ROADMAP queue 3)."""
    got = tpucomp_torch.compress_batch("lznt1", [b"", b"abc", b""],
                                       device="cpu")
    assert got[0] == got[2] == b""
    assert oracle.decompress(got[1]) == b"abc"
    assert tpucomp_torch.compress_batch("lznt1", [b"", b""],
                                        device="cpu") == [b"", b""]
    assert tpucomp_torch.compress_batch("lznt1", [], device="cpu") == []
    with pytest.raises(tpucomp_torch.ArgError, match="4096"):
        tpucomp_torch.compress_batch("lznt1", [b"a", bytes(CHUNK + 1)],
                                     device="cpu")
    with pytest.raises(OverflowError):
        tpucomp.compress_batch("lznt1", [b"", b"abc"])
    with pytest.raises(ValueError):
        tpucomp.compress_batch("lznt1", [bytes(CHUNK + 1)])


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 1 << 20])
def test_max_compressed_size_matches_tpucomp(n):
    assert tpucomp_torch.max_compressed_size("lznt1", n) == \
        tpucomp.max_compressed_size("lznt1", n)


def test_max_compressed_size_errors():
    with pytest.raises(tpucomp_torch.ArgError):
        tpucomp_torch.max_compressed_size("lznt1", -1)
    with pytest.raises(tpucomp_torch.UnsupportedFormatError,
                       match="not ported"):
        tpucomp_torch.max_compressed_size(tpucomp_torch.Format.LZX, 10)


def test_compress_on_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tpucomp_torch.compress("lznt1", b"abcabc"),
                 lambda: tpucomp_torch.compress_batch("lznt1", [b"abc"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()

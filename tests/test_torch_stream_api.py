"""The streaming ``Compressor`` / ``Decompressor`` on the CPU against
tpucomp's.

``backend="device"`` with ``device="cpu"`` (every kernel's plain
version) against tpucomp's ``backend="tpu"`` on its CPU devices: LZNT1
encode at ``unit_size`` 4096 and 8192 with feeds of 1, 700, 4096 and 5000
bytes; LZNT1 decode in feeds that are not aligned to chunks, over streams
that hold a stored chunk, a header-0 terminator partway through, a
malformed chunk and a truncated tail at ``flush``; ``decompress_unit`` of
plain Xpress and Xpress Huffman units; the ``ArgError`` cases.  Every
call's output (or exception class), ``total_in``, ``total_out`` and the
bytes left buffered must be equal.  The host backends (``"cpu"``,
``"oracle"``) against tpucomp's same backend in all three formats.  Last,
the port's LZNT1 streaming makes one device call per feed (plus one at
``flush``), where tpucomp makes one per unit or chunk.

The data is three 4 KiB chunks at most (text-like, random, text-like,
seeded with numpy): tpucomp's device backend takes seconds per call on
the CPU.  Every value is a byte or an integer: the tolerance is exact
equality.
"""

import random

import numpy as np
import pytest
import torch

import tpucomp
import tpucomp_torch
from conftest import make_corpus
from tpucomp_torch.codecs import lznt1
from _threads import _one_thread  # noqa: F401

SEED = 20261020
_rng = np.random.default_rng(SEED)
TEXT = make_corpus(random.Random(int(_rng.integers(1 << 31))), 6000)
# chunk 0 text, chunk 1 random (stored raw), chunk 2 text (partial)
DATA = TEXT[:4096] + _rng.integers(0, 256, 4096, np.uint8).tobytes() \
    + TEXT[4096:]

# a compressed chunk whose first token copies from before the chunk
MALFORMED = (0xB000 | 2).to_bytes(2, "little") + bytes([1, 0, 0])


def t_stream() -> bytes:
    return tpucomp.compress("lznt1", DATA, backend="cpu")


def chunk_spans(stream: bytes) -> list:
    spans, i = [], 0
    while i + 2 <= len(stream):
        size = ((stream[i] | stream[i + 1] << 8) & 0xFFF) + 1
        spans.append(stream[i:i + 2 + size])
        i += 2 + size
    return spans


def drive(obj, method: str, parts: list, *, final: bool = True) -> list:
    """Each call's outcome: its output or its exception's class name,
    then the counters and the bytes left buffered; the same for the
    flush."""
    calls = [getattr(obj, method)] * len(parts) + ([obj.flush] if final
                                                   else [])
    out = []
    for call, part in zip(calls, parts + [None]):
        try:
            got = call() if part is None else call(part)
        except Exception as e:  # noqa: BLE001 - the class is compared
            got = type(e).__name__
        out.append((got, obj.total_in, obj.total_out,
                    bytes(getattr(obj, "_buf", b""))))
    return out


def feeds(data: bytes, step: int) -> list:
    return [data[i:i + step] for i in range(0, len(data), step)]


def port(cls, fmt, **kw):
    return getattr(tpucomp_torch, cls)(fmt, device="cpu", **kw)


def tpu(cls, fmt, **kw):
    return getattr(tpucomp, cls)(fmt, backend="tpu", **kw)


# ---- LZNT1 on the device ---------------------------------------------------

@pytest.mark.parametrize("step", [1, 700, 4096, 5000])
@pytest.mark.parametrize("unit", [4096, 8192])
def test_lznt1_compressor(unit, step):
    got = drive(port("Compressor", "lznt1", unit_size=unit), "compress",
                feeds(DATA, step))
    want = drive(tpu("Compressor", "lznt1", unit_size=unit), "compress",
                 feeds(DATA, step))
    assert got == want
    stream = b"".join(g[0] for g in got)
    assert stream == tpucomp.compress("lznt1", DATA, backend="tpu")
    assert tpucomp_torch.decompress("lznt1", stream, backend="cpu") == DATA


def decoder_streams() -> dict:
    s = t_stream()
    c = chunk_spans(s)
    assert len(c) == 3 and not c[1][1] & 0x80  # the random chunk is stored
    return {
        "stored": s,
        # the end partway through a feed: what follows it is dropped, and
        # later feeds start a new stream mid-chunk
        "terminator": c[0] + c[1] + b"\0\0" + c[2] + c[0],
        "malformed": c[0] + MALFORMED + c[2] + c[1],
        "truncated": s[:-100],
    }


@pytest.mark.parametrize("step", [1, 700, 3001, 1 << 20])
@pytest.mark.parametrize("case", ["stored", "terminator", "malformed",
                                  "truncated"])
def test_lznt1_decompressor(case, step):
    stream = decoder_streams()[case]
    got = drive(port("Decompressor", "lznt1"), "decompress",
                feeds(stream, step))
    want = drive(tpu("Decompressor", "lznt1"), "decompress",
                 feeds(stream, step))
    assert got == want
    outcomes = [g[0] for g in got]
    if case == "stored":
        assert b"".join(outcomes) == DATA
    if case == "malformed":
        assert "DataError" in outcomes
    if case == "truncated":
        assert outcomes[-1] == "DataError"


def test_lznt1_decompressor_after_an_error():
    """After a malformed chunk the buffer holds what followed it in that
    feed; the next feeds decode on from there, in both packages."""
    c = chunk_spans(t_stream())
    parts = [c[0] + MALFORMED + c[2][:3], c[2][3:] + c[0]]
    got = drive(port("Decompressor", "lznt1"), "decompress", parts)
    want = drive(tpu("Decompressor", "lznt1"), "decompress", parts)
    assert got == want
    assert got[0] == ("DataError", len(parts[0]), 0, c[2][:3])
    assert got[1][0] == DATA[8192:] + DATA[:4096]


# ---- unit-framed Xpress and XH on the device --------------------------------

@pytest.mark.parametrize("fmt", ["xpress", "xpress_huff"])
def test_decompress_unit(fmt):
    units = [TEXT[:2500], TEXT[2500:3700]]
    streams = [tpucomp.compress(fmt, u, backend="cpu") for u in units]
    lens = [len(u) for u in units]
    got = port("Decompressor", fmt, unit_out_lens=lens)
    want = tpu("Decompressor", fmt, unit_out_lens=lens)
    for s, u in zip(streams, units):
        assert got.decompress_unit(s) == want.decompress_unit(s) == u
        assert (got.total_in, got.total_out) == \
            (want.total_in, want.total_out)
    for d, errors in ((got, tpucomp_torch), (want, tpucomp)):
        with pytest.raises(errors.ArgError, match="no unit_out_lens"):
            d.decompress_unit(streams[0])
    # an out_len-less decompress() raises after counting the bytes
    assert drive(port("Decompressor", fmt, unit_out_lens=lens), "decompress",
                 [b"abc"], final=False) == \
        drive(tpu("Decompressor", fmt, unit_out_lens=lens), "decompress",
              [b"abc"], final=False) == [("ArgError", 3, 0, b"abc")]


def test_xpress_unit_over_64k_raises_as_tpucomp():
    s = tpucomp.compress("xpress", bytes(70000), backend="cpu")
    for d, errors in ((port("Decompressor", "xpress", unit_out_lens=[70000]),
                       tpucomp_torch), (tpu("Decompressor", "xpress",
                                            unit_out_lens=[70000]), tpucomp)):
        with pytest.raises(errors.UnsupportedFormatError):
            d.decompress_unit(s)


# ---- the ArgError cases -------------------------------------------------------

def both_raise(make_port, make_tpu, port_cls, tpu_cls):
    with pytest.raises(port_cls):
        make_port()
    with pytest.raises(tpu_cls):
        make_tpu()


@pytest.mark.parametrize("fmt", ["xpress", "xpress_huff"])
def test_window_carry_on_the_device_raises(fmt):
    both_raise(lambda: port("Compressor", fmt),
               lambda: tpu("Compressor", fmt),
               tpucomp_torch.ArgError, tpucomp.ArgError)
    both_raise(lambda: port("Decompressor", fmt, out_len=10),
               lambda: tpu("Decompressor", fmt, out_len=10),
               tpucomp_torch.ArgError, tpucomp.ArgError)
    both_raise(lambda: port("Decompressor", fmt),
               lambda: tpu("Decompressor", fmt),
               tpucomp_torch.ArgError, tpucomp.ArgError)


@pytest.mark.parametrize("fmt,unit", [("lznt1", 5000), ("lznt1", 100),
                                      ("xpress_huff", 4096)])
@pytest.mark.parametrize("backend", ["device", "cpu"])
def test_bad_unit_size_raises(fmt, unit, backend):
    t_backend = "tpu" if backend == "device" else backend
    both_raise(lambda: tpucomp_torch.Compressor(
        fmt, backend=backend, unit_size=unit, device="cpu"),
        lambda: tpucomp.Compressor(fmt, backend=t_backend, unit_size=unit),
        tpucomp_torch.ArgError, tpucomp.ArgError)


def test_flush_twice_and_compress_after_flush():
    for c, errors in ((port("Compressor", "lznt1"), tpucomp_torch),
                      (tpu("Compressor", "lznt1"), tpucomp)):
        assert c.compress(b"abc") == b""
        assert c.flush() != b""
        assert c.flush() == b""
        with pytest.raises(errors.ArgError, match="already flushed"):
            c.compress(b"x")
        assert (c.total_in, c.total_out) == (3, 5)


def test_device_cuda_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tpucomp_torch.Compressor("lznt1"),
                 lambda: tpucomp_torch.Decompressor("lznt1"),
                 lambda: tpucomp_torch.Decompressor("xpress",
                                                    unit_out_lens=[1]),
                 lambda: tpucomp_torch.compress("xpress", b"abcabc"),
                 lambda: tpucomp_torch.decompress("lznt1", t_stream())):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


# ---- one device call per feed -------------------------------------------------

def test_lznt1_one_device_call_per_feed(monkeypatch):
    calls = {"encode_batch": 0, "decode_batch": 0}
    for name in calls:
        real = getattr(lznt1, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(lznt1, name, counted)
    c = port("Compressor", "lznt1")
    stream = c.compress(DATA[:8192 + 100])  # two units: one call
    assert calls["encode_batch"] == 1
    stream += c.compress(DATA[8192 + 100:8192 + 200])  # no unit: none
    assert calls["encode_batch"] == 1
    stream += c.flush()  # the tail: one more
    assert calls["encode_batch"] == 2
    assert stream == tpucomp_torch.compress("lznt1", DATA[:8392],
                                            device="cpu")
    s = t_stream()
    d = port("Decompressor", "lznt1")
    out = d.decompress(s)  # three chunks: one call
    assert calls["decode_batch"] == 1
    assert d.flush() == b"" and calls["decode_batch"] == 1
    assert out == DATA


# ---- the host backends -------------------------------------------------------

@pytest.mark.parametrize("backend", ["cpu", "oracle", "auto"])
def test_lznt1_host_backends(backend):
    s = t_stream()
    c = chunk_spans(s)
    for cls, method, data, step in (
            ("Compressor", "compress", DATA, 700),
            ("Decompressor", "decompress", s, 999),
            ("Decompressor", "decompress", c[0] + MALFORMED + c[2], 2000),
            ("Decompressor", "decompress", s[:-7], 3001)):
        got = drive(getattr(tpucomp_torch, cls)("lznt1", backend=backend),
                    method, feeds(data, step))
        want = drive(getattr(tpucomp, cls)("lznt1", backend=backend),
                     method, feeds(data, step))
        assert got == want


@pytest.mark.parametrize("backend", ["cpu", "oracle"])
@pytest.mark.parametrize("fmt", ["xpress", "xpress_huff"])
def test_window_carry_host_backends(fmt, backend):
    data = (DATA + TEXT) * (1 if backend == "oracle" else 12)
    got = drive(tpucomp_torch.Compressor(fmt, backend=backend), "compress",
                feeds(data, 50_001))
    want = drive(tpucomp.Compressor(fmt, backend=backend), "compress",
                 feeds(data, 50_001))
    assert got == want
    stream = b"".join(g[0] for g in got)
    got = drive(tpucomp_torch.Decompressor(fmt, backend=backend,
                                           out_len=len(data)),
                "decompress", feeds(stream, 777))
    want = drive(tpucomp.Decompressor(fmt, backend=backend,
                                      out_len=len(data)),
                 "decompress", feeds(stream, 777))
    assert got == want
    assert b"".join(g[0] for g in got) == data

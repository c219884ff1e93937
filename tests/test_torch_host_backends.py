"""The port's host backends on the CPU against tpucomp's.

``backend="cpu"`` is the port's copy of the native C codec
(``tpucomp_torch/native/tpucomp_native.c``, ``tpucomp_torch._native``),
``backend="oracle"`` its copy of the pure-Python spec codecs
(``tpucomp_torch.oracle``).  Both are held to tpucomp's ``_native`` and
``oracle`` byte for byte on seeded slices (numpy-seeded text-like bytes
with a tail of random bytes): every one-shot native call of the three
formats, the plain encoders also right after a resolved call (the copy
zeroes the resolved depth state; the plain encoders never read it), the
four window-carry stream engines over 1-byte feeds, 50001-byte feeds
astride the 64 KiB blocks and one whole feed, the oracle's one-shot and
stream classes at up to 32 KiB, and ``tpucomp_torch.compress`` /
``decompress`` with ``backend="cpu"``, ``"oracle"`` and ``"auto"``
against tpucomp's same backend.  Every value is a byte or an integer:
the tolerance is exact equality.  Last, no module of the port imports
JAX or tpucomp (an ``ast`` scan of the sources).
"""

import ast
import os
import random

import numpy as np
import pytest

import tpucomp
import tpucomp_torch
from conftest import make_corpus
from tpucomp import _native as t_native
from tpucomp import oracle as t_oracle
from tpucomp_torch import _native, oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261019
FORMATS = ("lznt1", "xpress", "xpress_huff")
NATIVE_CALLS = {"lznt1": ("lznt1_compress", "lznt1_decompress"),
                "xpress": ("xpress_compress", "xpress_decompress"),
                "xpress_huff": ("xh_compress", "xh_decompress")}


def seeded(n: int, seed: int = SEED) -> bytes:
    """``n`` bytes: text-like runs and patterns, then a tail of random
    bytes (a tenth, so that LZNT1 stores chunks raw), from ``seed``."""
    rng = np.random.default_rng(seed)
    tail = n // 10
    text = make_corpus(random.Random(int(rng.integers(1 << 31))), n - tail)
    return text + rng.integers(0, 256, tail, dtype=np.uint8).tobytes()


DATA = seeded(200_000)  # three 64 KiB blocks and a partial one
SMALL = DATA[:20_000] + DATA[-4_000:]  # the oracle's size


def same_error(port_call, t_call):
    """Both calls raise, with exception classes of the same name."""
    with pytest.raises(tpucomp_torch.MSCompError) as got:
        port_call()
    with pytest.raises(tpucomp.errors.MSCompError) as want:
        t_call()
    assert type(got.value).__name__ == type(want.value).__name__


# ---- the native one-shot calls --------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 4096, 65536, 65537, 200_000])
@pytest.mark.parametrize("fmt", FORMATS)
def test_native_oneshot_equals_tpucomp(fmt, n):
    comp, decomp = NATIVE_CALLS[fmt]
    data = DATA[:n]
    got = getattr(_native, comp)(data)
    assert got == getattr(t_native, comp)(data)
    assert getattr(_native, decomp)(got, n) == \
        getattr(t_native, decomp)(got, n) == data


def test_native_lznt1_decompress_without_out_len():
    s = t_native.lznt1_compress(DATA)
    assert _native.lznt1_decompress(s) == t_native.lznt1_decompress(s) == DATA


def test_plain_encoders_after_a_resolved_call():
    """The copy zeroes the depth state at each resolved call; the plain
    encoders never read it, so their bytes stay tpucomp's before and
    after resolved calls in either build."""
    for port, t in ((_native.xpress_compress, t_native.xpress_compress),
                    (_native.xh_compress, t_native.xh_compress)):
        want = t(DATA)
        assert port(DATA) == want
        _native.xh_compress_resolved(DATA[:70_000], 2)
        _native.xpress_compress_resolved(DATA[:70_000], 2)
        t_native.xh_compress_resolved(DATA[5:70_000], 2)
        t_native.xpress_compress_resolved(DATA[5:70_000], 2)
        assert port(DATA) == t(DATA) == want


@pytest.mark.parametrize("fmt", FORMATS)
def test_native_errors_like_tpucomp(fmt):
    comp, decomp = NATIVE_CALLS[fmt]
    s = getattr(t_native, comp)(DATA[:30_000])
    # cut short
    same_error(lambda: getattr(_native, decomp)(s[:len(s) // 2], 30_000),
               lambda: getattr(t_native, decomp)(s[:len(s) // 2], 30_000))
    # an out_len past the stream's end
    same_error(lambda: getattr(_native, decomp)(s, 40_000),
               lambda: getattr(t_native, decomp)(s, 40_000))
    if fmt != "lznt1":
        same_error(lambda: getattr(_native, decomp)(s, None),
                   lambda: getattr(t_native, decomp)(s, None))


# ---- the native stream engines --------------------------------------------

def feeds(data: bytes, step: int) -> list:
    return [data[i:i + step] for i in range(0, len(data), step)] or [b""]


FEEDS = {"1-byte": (DATA[:12_000], 1), "50001-byte": (DATA, 50_001),
         "whole": (DATA, len(DATA))}


def run_engine(engine, method: str, parts: list) -> list:
    """Each feed's output, then the flush's."""
    out = [getattr(engine, method)(p) for p in parts]
    return out + [engine.flush()]


@pytest.mark.parametrize("feed", FEEDS)
@pytest.mark.parametrize("fmt", ["xpress", "xpress_huff"])
def test_native_stream_engines_equal_tpucomp(fmt, feed):
    data, step = FEEDS[feed]
    port = run_engine(_native.NativeStreamCompressor(fmt), "compress",
                      feeds(data, step))
    want = run_engine(t_native.NativeStreamCompressor(fmt), "compress",
                      feeds(data, step))
    assert port == want
    stream = b"".join(port)
    if fmt == "xpress_huff":
        assert stream == _native.xh_compress(data)
    dstep = 1 if step == 1 else 50_001 if step == 50_001 else len(stream)
    port_d = run_engine(_native.NativeStreamDecompressor(fmt, len(data)),
                        "decompress", feeds(stream, dstep))
    want_d = run_engine(t_native.NativeStreamDecompressor(fmt, len(data)),
                        "decompress", feeds(stream, dstep))
    assert port_d == want_d
    assert b"".join(port_d) == data


@pytest.mark.parametrize("fmt", ["xpress", "xpress_huff"])
def test_native_stream_decoder_errors_like_tpucomp(fmt):
    comp = NATIVE_CALLS[fmt][0]
    s = getattr(t_native, comp)(DATA[:70_000])
    for build, mod in ((lambda: _native.NativeStreamDecompressor(fmt, 70_000),
                        _native),
                       (lambda: t_native.NativeStreamDecompressor(fmt, 70_000),
                        t_native)):
        d = build()
        d.decompress(s[:len(s) // 2])
        with pytest.raises(mod.DataError):
            d.flush()
        d.close()
        d.close()  # closing twice frees once
    with pytest.raises(tpucomp_torch.ArgError):
        _native.NativeStreamDecompressor(fmt, None)


# ---- the oracle copy --------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_oracle_oneshot_equals_tpucomp(fmt):
    port, t = getattr(oracle, fmt), getattr(t_oracle, fmt)
    for data in (b"", SMALL[:1], SMALL):
        s = port.compress(data)
        assert s == t.compress(data)
        assert port.decompress(s, len(data)) == t.decompress(s, len(data)) \
            == data
        assert port.max_compressed_size(len(data)) == \
            t.max_compressed_size(len(data))
    if fmt == "xpress_huff":
        s = port.compress(SMALL, cross_block=True)
        assert s == t.compress(SMALL, cross_block=True)


@pytest.mark.parametrize("fmt", ["xpress", "xpress_huff"])
def test_oracle_stream_classes_equal_tpucomp(fmt):
    port, t = getattr(oracle, fmt), getattr(t_oracle, fmt)
    data = SMALL[:2_000] + SMALL * 2  # past 32 KiB only when joined
    data = data[:32_768]
    for step in (997, len(data)):
        got = run_engine(port.StreamCompressor(), "compress",
                         feeds(data, step))
        assert got == run_engine(t.StreamCompressor(), "compress",
                                 feeds(data, step))
        stream = b"".join(got)
        back = run_engine(port.StreamDecompressor(len(data)), "decompress",
                          feeds(stream, 333))
        assert back == run_engine(t.StreamDecompressor(len(data)),
                                  "decompress", feeds(stream, 333))
        assert b"".join(back) == data


@pytest.mark.parametrize("fmt", FORMATS)
def test_oracle_errors_are_the_ports(fmt):
    port, t = getattr(oracle, fmt), getattr(t_oracle, fmt)
    s = t.compress(SMALL[:5_000])
    bad = s[:len(s) // 3]
    same_error(lambda: port.decompress(bad, 5_000),
               lambda: t.decompress(bad, 5_000))


# ---- the public calls with backend= ----------------------------------------

@pytest.mark.parametrize("backend", ["cpu", "oracle", "auto"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_api_backends_equal_tpucomp(fmt, backend):
    data = SMALL if backend == "oracle" else DATA
    s = tpucomp_torch.compress(fmt, data, backend=backend)
    assert s == tpucomp.compress(fmt, data, backend=backend)
    out_len = None if fmt == "lznt1" else len(data)
    assert tpucomp_torch.decompress(fmt, s, out_len, backend=backend) == \
        tpucomp.decompress(fmt, s, out_len, backend=backend) == data
    if fmt != "lznt1":
        same_error(
            lambda: tpucomp_torch.decompress(fmt, s, None, backend=backend),
            lambda: tpucomp.decompress(fmt, s, None, backend=backend))


def test_api_backend_names():
    """``"auto"`` is ``"cpu"``; an unknown backend or format raises
    :class:`UnsupportedFormatError`, as tpucomp's."""
    assert tpucomp_torch.compress("xpress", DATA, backend="auto") == \
        _native.xpress_compress(DATA)
    for call in (lambda: tpucomp_torch.compress("lznt1", b"ab", backend="tpu"),
                 lambda: tpucomp_torch.decompress("lznt1", b"ab",
                                                  backend="gpu"),
                 lambda: tpucomp_torch.compress("lzx", b"ab", backend="cpu")):
        with pytest.raises(tpucomp_torch.UnsupportedFormatError):
            call()
    with pytest.raises(tpucomp.UnsupportedFormatError):
        tpucomp.compress("lznt1", b"ab", backend="gpu")
    with pytest.raises(tpucomp_torch.ArgError):
        tpucomp_torch.compress("lznt1", None, backend="cpu")


def test_failed_build_raises(monkeypatch, tmp_path):
    """A C build that fails raises; nothing falls back to the oracle."""
    from tpucomp_torch.kernels import _build

    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setenv("CC", "false")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(Exception) as e:
        tpucomp_torch.compress("lznt1", b"abcabc", backend="cpu")
    assert not isinstance(e.value, tpucomp_torch.MSCompError)


# ---- no JAX, no tpucomp -----------------------------------------------------

def imported_modules(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def port_sources() -> list:
    root = os.path.join(REPO, "tpucomp_torch")
    paths = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
             if f.endswith(".py")]
    return sorted(paths) + [os.path.join(REPO, "chip_smoke.py")]


def test_port_imports_neither_jax_nor_tpucomp():
    paths = port_sources()
    assert any(p.endswith(os.path.join("oracle", "xpress_huff.py"))
               for p in paths)
    bad = {os.path.relpath(p, REPO): sorted(
        m for m in imported_modules(p)
        if m.split(".")[0] in ("jax", "jaxlib", "tpucomp"))
        for p in paths}
    assert {p: m for p, m in bad.items() if m} == {}

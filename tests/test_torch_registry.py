"""tpucomp_torch's codec registry on the CPU against tpucomp's.

``formats.CodecEntry`` / ``register`` / ``lookup`` /
``registered_formats``, ``errors.raise_for_status``, and the public calls
that pick their codec through the registry: the same bytes as the direct
codec calls in every format and backend, a backend that a test
registers reached through ``backend=``, and the package's import of
neither JAX nor tpucomp.  Every value is a byte or an integer, so the
tolerance is exact equality.
"""

import os
import random
import subprocess
import sys

import pytest

import tpucomp
import tpucomp_torch
from conftest import make_corpus
from tpucomp_torch import _native, errors, formats
from tpucomp_torch import oracle as port_oracle
from tpucomp_torch.codecs import lznt1, xpress, xpress_huff
from tpucomp_torch.formats import Format
from _threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = (Format.LZNT1, Format.XPRESS, Format.XPRESS_HUFF)
DATA = make_corpus(random.Random(20), 3000)


def test_registered_formats():
    """The counterpart of tpucomp's ``test_registered_formats``."""
    fmts = tpucomp_torch.registered_formats()
    assert Format.LZNT1 in fmts
    assert Format.XPRESS in fmts
    assert Format.XPRESS_HUFF in fmts
    assert [int(f) for f in fmts] == \
        [int(f) for f in tpucomp.registered_formats()]


def test_backends_of_each_format():
    for fmt in FORMATS:
        entry = formats.lookup(fmt)
        assert entry.fmt == fmt and entry.streaming
        assert sorted(entry.backends) == ["cpu", "device", "oracle"]
        t_entry = tpucomp.formats.lookup(int(fmt))
        for n in (0, 1, 4096, 65537, 300000):
            assert entry.max_compressed_size(n) == \
                t_entry.max_compressed_size(n)


@pytest.mark.parametrize("fmt", ["lzx", Format.NONE, 5, Format.LZX])
def test_lookup_of_an_unregistered_format_raises(fmt):
    with pytest.raises(tpucomp_torch.UnsupportedFormatError,
                       match="not registered"):
        formats.lookup(fmt)
    with pytest.raises(tpucomp.UnsupportedFormatError):
        tpucomp.formats.lookup(fmt)


def test_lookup_of_an_unknown_name_and_backend_raises():
    with pytest.raises(tpucomp_torch.UnsupportedFormatError, match="bogus"):
        formats.lookup("bogus")
    with pytest.raises(tpucomp_torch.UnsupportedFormatError,
                       match="no 'tpu' backend"):
        formats.lookup("lznt1").get("tpu")
    assert formats.lookup(Format.DEFAULT) is formats.lookup("lznt1")
    assert formats.lookup(2) is formats.lookup("LZNT1")


def test_raise_for_status_maps_every_status_as_tpucomp():
    for status in errors.Status:
        t_status = tpucomp.Status(int(status))
        try:
            errors.raise_for_status(status, "msg")
            got = None
        except errors.MSCompError as e:
            got = (type(e).__name__, str(e), e.status)
        try:
            tpucomp.errors.raise_for_status(t_status, "msg")
            want = None
        except tpucomp.MSCompError as e:
            want = (type(e).__name__, str(e), e.status)
        assert got == want
    assert {s: c.__name__ for s, c in errors.STATUS_TO_ERROR.items()} == \
        {errors.Status(int(s)): c.__name__
         for s, c in tpucomp.errors.STATUS_TO_ERROR.items()}


# ---- a backend registered by the caller -------------------------------------

class _Recorder:
    """A backend of the test's own: each call recorded, the oracle's
    bytes returned."""

    def __init__(self, fmt):
        self.mod = {Format.LZNT1: port_oracle.lznt1,
                    Format.XPRESS: port_oracle.xpress,
                    Format.XPRESS_HUFF: port_oracle.xpress_huff}[fmt]
        self.calls = []

    def compress(self, data, **opts):
        self.calls.append(("compress", len(data), opts))
        return self.mod.compress(data, **opts)

    def decompress(self, data, out_len, **opts):
        self.calls.append(("decompress", len(data), out_len, opts))
        return self.mod.decompress(data, out_len)


@pytest.fixture
def mine(monkeypatch):
    """Register ``"mine"`` for every format, and take it out after."""
    recs = {}
    for fmt in FORMATS:
        entry = formats.lookup(fmt)
        monkeypatch.setitem(formats._REGISTRY, fmt, formats.CodecEntry(
            fmt, dict(entry.backends), entry.max_compressed_size,
            entry.streaming))
        recs[fmt] = rec = _Recorder(fmt)
        formats.register(fmt, "mine", rec.compress, rec.decompress)
    return recs


@pytest.mark.parametrize("fmt", FORMATS)
def test_registered_backend_through_compress_and_decompress(mine, fmt):
    rec = mine[fmt]
    s = tpucomp_torch.compress(fmt, DATA, backend="mine")
    assert s == rec.mod.compress(DATA)
    assert tpucomp_torch.decompress(fmt, s, len(DATA), backend="mine") == DATA
    # device= reaches the "device" backend alone
    assert rec.calls == [("compress", len(DATA), {}),
                         ("decompress", len(s), len(DATA), {})]
    assert "mine" in formats.lookup(fmt).backends


def test_registered_backend_through_the_lznt1_classes(mine):
    """The LZNT1 classes call a registered backend's compress with each
    feed's complete units and the tail, and its decompress a chunk."""
    rec = mine[Format.LZNT1]
    data = make_corpus(random.Random(21), 10000)
    c = tpucomp_torch.Compressor("lznt1", backend="mine")
    assert c.backend == "mine"
    s = c.compress(data[:5000]) + c.compress(data[5000:]) + c.flush()
    assert s == port_oracle.lznt1.compress(data)
    assert [call[:2] for call in rec.calls] == [
        ("compress", 4096), ("compress", 4096), ("compress", 1808)]
    rec.calls.clear()
    d = tpucomp_torch.Decompressor("lznt1", backend="mine")
    assert d.decompress(s[:700]) + d.decompress(s[700:]) + d.flush() == data
    assert [call[0] for call in rec.calls] == ["decompress"] * 3
    assert all(call[2] is None for call in rec.calls)


@pytest.mark.parametrize("fmt", [Format.XPRESS, Format.XPRESS_HUFF])
def test_registered_backend_refused_by_the_xpress_classes(mine, fmt):
    """tpucomp's Xpress and XH classes refuse a backend other than
    ``"cpu"`` and ``"oracle"`` (its ``"tpu"``) with ArgError; the port's
    refuse ``"device"`` and a registered one alike."""
    for make in (lambda: tpucomp_torch.Compressor(fmt, backend="mine"),
                 lambda: tpucomp_torch.Decompressor(fmt, backend="mine",
                                                    out_len=10)):
        with pytest.raises(tpucomp_torch.ArgError, match="'mine'"):
            make()
    with pytest.raises(tpucomp.ArgError):
        tpucomp.Compressor(int(fmt), backend="tpu")
    assert mine[fmt].calls == []
    # the unit-framed decoder takes it: one decompress a unit
    s = mine[fmt].mod.compress(DATA)
    d = tpucomp_torch.Decompressor(fmt, backend="mine",
                                   unit_out_lens=[len(DATA)])
    assert d.decompress_unit(s) == DATA


def test_unregistered_backend_raises(mine):
    for call in (lambda: tpucomp_torch.compress("lznt1", DATA, backend="x"),
                 lambda: tpucomp_torch.Decompressor("lznt1", backend="x")):
        with pytest.raises(tpucomp_torch.UnsupportedFormatError,
                           match="no 'x' backend"):
            call()


# ---- the registry against the direct codec calls ----------------------------

DIRECT = {
    "device": {Format.LZNT1: (lznt1.compress, lznt1.decompress),
               Format.XPRESS: (xpress.compress, xpress.decompress),
               Format.XPRESS_HUFF: (xpress_huff.compress,
                                    xpress_huff.decompress)},
    "cpu": {Format.LZNT1: (_native.lznt1_compress, _native.lznt1_decompress),
            Format.XPRESS: (_native.xpress_compress,
                            _native.xpress_decompress),
            Format.XPRESS_HUFF: (_native.xh_compress, _native.xh_decompress)},
    "oracle": {Format.LZNT1: (port_oracle.lznt1.compress,
                              port_oracle.lznt1.decompress),
               Format.XPRESS: (port_oracle.xpress.compress,
                               port_oracle.xpress.decompress),
               Format.XPRESS_HUFF: (port_oracle.xpress_huff.compress,
                                    port_oracle.xpress_huff.decompress)},
}


@pytest.mark.parametrize("backend", ["device", "cpu", "oracle"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_registry_equals_the_direct_codec_calls(fmt, backend):
    comp, decomp = DIRECT[backend][fmt]
    kw = {"device": "cpu"} if backend == "device" else {}
    data = DATA[:400] if backend == "device" else DATA
    s = tpucomp_torch.compress(fmt, data, backend=backend, **kw)
    assert s == comp(data, **kw)
    assert tpucomp_torch.decompress(fmt, s, len(data), backend=backend,
                                    **kw) == decomp(s, len(data), **kw) == data
    assert formats.lookup(fmt).get(backend)[0] is comp


# ---- no JAX, no tpucomp -----------------------------------------------------

def test_importing_the_port_loads_neither_jax_nor_tpucomp():
    """Importing the port fills its registry, and neither that nor a call
    through each registered backend loads JAX or tpucomp."""
    code = ("import sys; before = set(sys.modules); import tpucomp_torch; "
            "fmts = tpucomp_torch.registered_formats(); "
            "s = tpucomp_torch.compress('xpress', b'abcabc' * 50, "
            "backend='oracle'); "
            "assert tpucomp_torch.decompress('xpress', s, 300, "
            "device='cpu') == b'abcabc' * 50; "
            "print(len(fmts), sorted(m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'tpucomp')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "3 []"

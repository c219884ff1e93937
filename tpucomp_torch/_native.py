"""ctypes binding of the port's copy of tpucomp's native C codec: the
``backend="cpu"`` of :mod:`tpucomp_torch.api`.

``native/tpucomp_native.c`` is tpucomp's ``tpucomp/native/
tpucomp_native.c`` (LZNT1, plain Xpress and Xpress Huffman one-shot
encode and decode, the resolved encoders, the four window-carry stream
engines), with one change: a resolved call starts from a zeroed depth
state.  It is built with the host C compiler (``cc -O3 -fPIC -shared``,
or ``$CC``) at first use into ``tpucomp_torch/_build/``, beside the CUDA
kernels; a failed build raises.  The calls below are tpucomp's
``_native`` calls: the same output capacities, the same status checks
(-3 is :class:`BufError`, any other negative :class:`DataError`), the
same bytes.  This is host code; no kernel runs here.
"""

from __future__ import annotations

import ctypes
import os
import shutil

from .errors import ArgError, BufError, DataError
from .formats import Format, canonical

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "tpucomp_native.c")
CFLAGS = ["-O3", "-fPIC", "-shared"]
# encoder option flags (tpucomp_native.c OPT_*)
OPT_RESOLVE_OFFSETS = 1
STREAM_ENGINES = ("xp_scomp", "xh_scomp", "xp_sdec", "xh_sdec")

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from .kernels import _build

        cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
        if not cc:
            raise RuntimeError("no C compiler (cc, gcc or $CC) to build "
                               "tpucomp_torch/native/tpucomp_native.c")
        lib = ctypes.CDLL(_build.shared_library(cc, CFLAGS, [_SRC],
                                                "tpucomp_torch_native")[0])
        buf_args = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                    ctypes.c_int]
        for fn in (lib.lznt1_compress, lib.lznt1_decompress,
                   lib.xpress_compress, lib.xpress_decompress,
                   lib.xh_compress, lib.xh_decompress):
            fn.argtypes = buf_args
            fn.restype = ctypes.c_int
        for fn in (lib.xpress_compress_opt, lib.xh_compress_opt):
            fn.argtypes = buf_args + [ctypes.c_int]
            fn.restype = ctypes.c_int
        for pre in STREAM_ENGINES:
            new = getattr(lib, pre + "_new")
            new.restype = ctypes.c_void_p
            new.argtypes = [ctypes.c_long] if pre.endswith("sdec") else []
            free = getattr(lib, pre + "_free")
            free.restype = None
            free.argtypes = [ctypes.c_void_p]
            for suffix, extra in (("_feed", [ctypes.c_char_p, ctypes.c_int]),
                                  ("_finish", []), ("_avail", []),
                                  ("_read", [ctypes.c_char_p, ctypes.c_int])):
                fn = getattr(lib, pre + suffix)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p] + extra
        _lib = lib
    return _lib


# the C codec's status for an over-subscribed XH table (a DataError here;
# tpucomp's copy of the C writes past its lookup table there instead)
ERR_TABLE = -5


def _check(rc: int) -> int:
    if rc == -3:
        raise BufError("native: output buffer too small")
    if rc < 0:
        raise DataError("native: malformed stream")
    return rc


def _call(fn, data: bytes, out_cap: int, *extra) -> bytes:
    out = ctypes.create_string_buffer(out_cap)
    rc = _check(fn(data, len(data), out, out_cap, *extra))
    return out.raw[:rc]


def _bound(n: int) -> int:
    return n + 2 * (n // 4096 + 2) + 16


def _xh_bound(n: int) -> int:
    return max(1, (n + 65535) // 65536) * 264 + 2 * n + 16


def _xpress_bound(n: int) -> int:
    return n + 4 * (n // 32 + 2) + 16


def lznt1_compress(data: bytes) -> bytes:
    return _call(_load().lznt1_compress, bytes(data), _bound(len(data)))


def lznt1_decompress(data: bytes, out_len=None) -> bytes:
    data = bytes(data)
    cap = (out_len if out_len is not None
           else max(4096, 4096 * (len(data) // 2 + 2)))
    r = _call(_load().lznt1_decompress, data, cap)
    if out_len is not None:
        if len(r) < out_len:
            raise DataError("LZNT1: stream ended before out_len bytes")
        r = r[:out_len]
    return r


def xpress_compress(data: bytes) -> bytes:
    return _call(_load().xpress_compress, bytes(data),
                 _xpress_bound(len(data)))


def xpress_decompress(data: bytes, out_len: int) -> bytes:
    if out_len is None:
        raise ArgError("Xpress: out_len is required")
    return _call(_load().xpress_decompress, bytes(data), out_len)


def xh_compress(data: bytes) -> bytes:
    return _call(_load().xh_compress, bytes(data), _xh_bound(len(data)))


def xh_decompress(data: bytes, out_len: int) -> bytes:
    if out_len is None:
        raise ArgError("XpressHuff: out_len is required")
    return _call(_load().xh_decompress, bytes(data), out_len)


def register_all():
    """Register the one-shot calls of each format as the ``"cpu"``
    backend.  Unlike tpucomp's, this builds nothing: the library is built
    at the first call, and a failed build raises there."""
    from .formats import register

    register(Format.LZNT1, "cpu", lznt1_compress, lznt1_decompress)
    register(Format.XPRESS, "cpu", xpress_compress, xpress_decompress)
    register(Format.XPRESS_HUFF, "cpu", xh_compress, xh_decompress)


def _depth_flags(max_depth: int) -> int:
    if not 0 <= max_depth <= 15:
        raise ArgError("max_depth must be in [0, 15]")
    return (max_depth & 0xF) << 8


def _default_depth() -> int:
    # the decoder's archive probe budget: archives written at this depth
    # resolve entirely in the far_probe rounds of fast_resolve
    from .kernels.common import ARCHIVE_PROBE_BUDGET

    return ARCHIVE_PROBE_BUDGET


def xh_compress_resolved(data: bytes, max_depth: int | None = None) -> bytes:
    """XH encode in the archive profile: each far match's offset ascends
    to its source's origin, and matches are shortened or dropped so that
    no byte needs more than ``max_depth`` full-row rounds after the near
    walk and the 4 KiB level (0: no bound, the ascent alone).  The
    stream is standard [MS-XCA] §2.1-2.2, 64 KiB blocks.  The default is
    ``kernels.common.ARCHIVE_PROBE_BUDGET``, the probe rounds of
    ``decompress_units(..., fast_resolve=True)``."""
    if max_depth is None:
        max_depth = _default_depth()
    flags = OPT_RESOLVE_OFFSETS | _depth_flags(max_depth)
    return _call(_load().xh_compress_opt, bytes(data), _xh_bound(len(data)),
                 flags)


def xpress_compress_resolved(data: bytes,
                             max_depth: int | None = None) -> bytes:
    """Plain Xpress encode in the archive profile (the ascent capped by
    the format's 8192-byte window); see :func:`xh_compress_resolved`."""
    if max_depth is None:
        max_depth = _default_depth()
    flags = OPT_RESOLVE_OFFSETS | _depth_flags(max_depth)
    return _call(_load().xpress_compress_opt, bytes(data),
                 _xpress_bound(len(data)), flags)


class _NativeStream:
    """Common wrapper of the C stream engines (feed/avail/read/finish)."""

    def __init__(self, prefix: str, *new_args):
        lib = _load()
        self._new = getattr(lib, prefix + "_new")
        self._feed = getattr(lib, prefix + "_feed")
        self._finish = getattr(lib, prefix + "_finish")
        self._avail = getattr(lib, prefix + "_avail")
        self._read = getattr(lib, prefix + "_read")
        self._free = getattr(lib, prefix + "_free")
        self._h = self._new(*new_args)
        if not self._h:
            raise ArgError("native stream: allocation failed")

    def _drain(self) -> bytes:
        # read until the engine holds nothing: *_avail returns an int, so
        # one read would cap a backlog over INT_MAX bytes
        parts = []
        while True:
            n = _check(self._avail(self._h))
            if not n:
                break
            buf = ctypes.create_string_buffer(n)
            got = _check(self._read(self._h, buf, n))
            if not got:
                break
            parts.append(buf.raw[:got])
        return b"".join(parts)

    def feed(self, data: bytes) -> bytes:
        data = bytes(data)
        _check(self._feed(self._h, data, len(data)))
        return self._drain()

    def finish(self) -> bytes:
        _check(self._finish(self._h))
        return self._drain()

    def close(self):
        if self._h:
            self._free(self._h)
            self._h = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:
            pass


class NativeStreamCompressor(_NativeStream):
    """Window-carry native stream encoder (XPRESS / XPRESS_HUFF).

    ``compress(b)`` gives the stream bytes final so far, ``flush()`` the
    rest.  XPRESS_HUFF: the streamed bytes equal one-shot
    :func:`xh_compress` of the concatenation for any feed slicing.
    XPRESS: equal to one-shot :func:`xpress_compress` unless one match
    would span more than 1 MiB of input not yet fed (it is then emitted
    early; the stream stays valid).
    """

    def __init__(self, fmt):
        prefix = {Format.XPRESS: "xp_scomp",
                  Format.XPRESS_HUFF: "xh_scomp"}[canonical(fmt)]
        super().__init__(prefix)

    compress = _NativeStream.feed
    flush = _NativeStream.finish


class NativeStreamDecompressor(_NativeStream):
    """Window-carry native stream decoder (XPRESS / XPRESS_HUFF).

    Feed any slices of one standard stream; decoded bytes come out as
    soon as their tokens or blocks are complete.  ``out_len`` is the
    total decoded size (the formats carry no size header).
    """

    def __init__(self, fmt, out_len: int):
        if out_len is None or out_len < 0:
            raise ArgError("out_len is required")
        prefix = {Format.XPRESS: "xp_sdec",
                  Format.XPRESS_HUFF: "xh_sdec"}[canonical(fmt)]
        super().__init__(prefix, out_len)

    decompress = _NativeStream.feed
    flush = _NativeStream.finish

"""ctypes binding of the port's copy of tpucomp's native resolved encoders.

``native/resolved.c`` holds tpucomp's ``xpress_compress_opt`` and
``xh_compress_opt`` unchanged; it is built with the host C compiler (``cc
-O3 -fPIC -shared``, or ``$CC``) at first use into ``tpucomp_torch/
_build/``, beside the CUDA kernels.  The two calls below are tpucomp's
``_native.xh_compress_resolved`` and ``xpress_compress_resolved``: the
same output capacities, the same depth check, the same bytes.  This is
host code, the encoder of ``ShardedCodec(..., resolve_offsets=True)``;
no kernel runs here.
"""

from __future__ import annotations

import ctypes
import os
import shutil

from .errors import ArgError, BufError, DataError

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "resolved.c")
CFLAGS = ["-O3", "-fPIC", "-shared"]
# encoder option flags (resolved.c OPT_*)
OPT_RESOLVE_OFFSETS = 1

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from .kernels import _build

        cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
        if not cc:
            raise RuntimeError("no C compiler (cc, gcc or $CC) to build "
                               "tpucomp_torch/native/resolved.c")
        lib = ctypes.CDLL(_build.shared_library(cc, CFLAGS, [_SRC],
                                                "tpucomp_torch_native")[0])
        for fn in (lib.xpress_compress_opt, lib.xh_compress_opt):
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                           ctypes.c_int, ctypes.c_int]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _depth_flags(max_depth: int) -> int:
    if not 0 <= max_depth <= 15:
        raise ArgError("max_depth must be in [0, 15]")
    return (max_depth & 0xF) << 8


def _call_opt(fn, data: bytes, out_cap: int, flags: int) -> bytes:
    out = ctypes.create_string_buffer(out_cap)
    rc = fn(data, len(data), out, out_cap, flags)
    if rc == -3:
        raise BufError("native: output buffer too small")
    if rc < 0:
        raise DataError("native: malformed stream")
    return out.raw[:rc]


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
    n = len(data)
    nb = max(1, (n + 65535) // 65536)
    return _call_opt(_load().xh_compress_opt, bytes(data),
                     nb * 264 + 2 * n + 16, flags)


def xpress_compress_resolved(data: bytes,
                             max_depth: int | None = None) -> bytes:
    """Plain Xpress encode in the archive profile (the ascent capped by
    the format's 8192-byte window); see :func:`xh_compress_resolved`."""
    if max_depth is None:
        max_depth = _default_depth()
    flags = OPT_RESOLVE_OFFSETS | _depth_flags(max_depth)
    n = len(data)
    return _call_opt(_load().xpress_compress_opt, bytes(data),
                     n + 4 * (n // 32 + 2) + 16, flags)

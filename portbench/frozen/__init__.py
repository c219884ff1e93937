"""ctypes binding of the frozen C codecs (``codec.c``).

The library is built with the host C compiler (``$CC``, else ``cc`` or
``gcc``) at first use into ``portbench/.build/``, under a name that
carries a hash of the flags and the source, so that a second run in the
same checkout finds it built.  The build goes to a private file and is
renamed into place, so a concurrent loader never sees half a library.
The encoders keep static scratch: call them from one thread at a time.

``control=True`` calls the build with ``-DPORTBENCH_CONTROL``: encoders
that take a hash candidate's first 3 bytes as matching without comparing
them (the control of the write cells' check).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "codec.c")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), ".build")
CFLAGS = ["-O3", "-fPIC", "-shared"]

_libs = {}


def build(control: bool = False) -> str:
    """The built library's path; compiles it unless it exists."""
    flags = CFLAGS + ["-DPORTBENCH_CONTROL"] * control
    with open(SOURCE, "rb") as f:
        key = hashlib.sha256(" ".join(flags).encode() + f.read())
    path = os.path.join(BUILD_DIR, f"libfrozen-{key.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if not cc:
        raise RuntimeError("no C compiler (cc, gcc or $CC) to build "
                           f"{SOURCE}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        subprocess.run([cc, *flags, "-o", tmp, SOURCE], check=True,
                       capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load(control: bool) -> ctypes.CDLL:
    if control not in _libs:
        lib = ctypes.CDLL(build(control))
        for name in ("lznt1_compress", "lznt1_decompress", "xh_compress",
                     "xh_decompress"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                           ctypes.c_int]
            fn.restype = ctypes.c_int
        _libs[control] = lib
    return _libs[control]


def _call(name: str, data: bytes, cap: int, control: bool = False) -> bytes:
    out = ctypes.create_string_buffer(cap)
    rc = getattr(_load(control), name)(data, len(data), out, cap)
    if rc < 0:
        raise ValueError(f"frozen {name}: status {rc}")
    return out.raw[:rc]


def lznt1_compress(data: bytes, control: bool = False) -> bytes:
    """One LZNT1 stream of 4 KiB chunks, each compressed or stored raw."""
    return _call("lznt1_compress", data,
                 len(data) + 2 * (len(data) // 4096 + 2), control)


def lznt1_decompress(stream: bytes, cap: int) -> bytes:
    return _call("lznt1_decompress", stream, cap)


def xh_compress(data: bytes, control: bool = False) -> bytes:
    """One Xpress Huffman stream, one block a 64 KiB of ``data``."""
    n = len(data)
    return _call("xh_compress", data,
                 max(1, -(-n // 65536)) * 264 + 2 * n + 16, control)


def xh_decompress(stream: bytes, out_len: int) -> bytes:
    return _call("xh_decompress", stream, out_len)

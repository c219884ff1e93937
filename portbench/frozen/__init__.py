"""ctypes binding of the frozen C encoders and decoders (``frozen/*.c``).

Every ``frozen/*.c`` under the benchmark's root is compiled, in sorted
order, into one library with the host C compiler (``$CC``, else ``cc``
or ``gcc``) at first use into ``.build/`` beside them, under a name that
carries a hash of the flags and of each source's name and bytes, so that
a second run in the same checkout finds it built.  The build goes to a
private file and is renamed into place, so a concurrent loader never
sees half a library.  The encoders keep static scratch: call them from
one thread at a time.

A format's encoder is the exported symbol ``<format>_compress(in, n,
out, cap)``, which returns the stream's length or a negative status;
:func:`compress` finds it by the format's name.  ``control=True`` calls
the build with ``-DPORTBENCH_CONTROL``, the control of the write cells'
check: each encoder with one of its format's guarantees broken (those of
``codec.c`` take a hash candidate's first 3 bytes as matching without
comparing them).  The control encoder of a format whose source does not
mention ``PORTBENCH_CONTROL`` is refused.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

from ..spec import ROOT

CFLAGS = ["-O3", "-fPIC", "-shared"]
CONTROL = "PORTBENCH_CONTROL"
_NAME = re.compile(r"[a-z0-9_]+")

_libs = {}
_controlled = {}


def sources(root: str = ROOT) -> list:
    """The frozen C sources under ``root``, in the order they are built."""
    return sorted(glob.glob(os.path.join(root, "frozen", "*.c")))


def build(control: bool = False, root: str = ROOT) -> str:
    """The built library's path; compiles it unless it exists."""
    flags = CFLAGS + [f"-D{CONTROL}"] * control
    srcs = sources(root)
    if not srcs:
        raise FileNotFoundError(f"no frozen/*.c under {root}")
    key = hashlib.sha256(" ".join(flags).encode())
    for src in srcs:
        with open(src, "rb") as f:
            key.update(b"\0" + os.path.basename(src).encode() + b"\0")
            key.update(f.read())
    build_dir = os.path.join(root, ".build")
    path = os.path.join(build_dir, f"libfrozen-{key.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if not cc:
        raise RuntimeError("no C compiler (cc, gcc or $CC) to build "
                           f"{', '.join(srcs)}")
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=build_dir, suffix=".so")
    os.close(fd)
    try:
        done = subprocess.run([cc, *flags, "-o", tmp, *srcs],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"{cc} failed on {', '.join(srcs)}:\n"
                               f"{done.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _symbol(name: str, control: bool, root: str):
    """The library's function ``name``, typed ``(in, n, out, cap) ->
    int``; raises ValueError where no source exports it."""
    if (root, control) not in _libs:
        _libs[root, control] = ctypes.CDLL(build(control, root))
    try:
        fn = getattr(_libs[root, control], name)
    except AttributeError:
        raise ValueError(
            f"no symbol {name!r} in the frozen library of "
            f"{', '.join(os.path.relpath(s, root) for s in sources(root))}"
        ) from None
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def _call(name: str, data: bytes, cap: int, control: bool = False,
          root: str = ROOT) -> bytes:
    out = ctypes.create_string_buffer(cap)
    rc = _symbol(name, control, root)(data, len(data), out, cap)
    if rc < 0:
        raise ValueError(f"frozen {name}: status {rc}")
    return ctypes.string_at(out, rc)


def _source_of(name: str, root: str) -> str:
    """The source that defines the exported function ``name``."""
    define = re.compile(rf"^[A-Za-z_][\w \t*]*\b{name}\s*\(", re.M)
    for src in sources(root):
        with open(src) as f:
            text = f.read()
        if define.search(text):
            return src
    raise ValueError(f"no frozen/*.c under {root} defines {name!r}")


def compress(fmt: str, data: bytes, control: bool = False,
             root: str = ROOT) -> bytes:
    """The frozen encoder's stream of ``data`` in format ``fmt``: the
    symbol ``<fmt>_compress`` of the library built from ``root``'s
    ``frozen/*.c`` (with ``control``, of its control build).  Raises
    ValueError where no source exports it, or, for the control, where
    the source that does takes no notice of ``PORTBENCH_CONTROL``."""
    if not _NAME.fullmatch(fmt):
        raise ValueError(f"no frozen encoder for format {fmt!r}")
    name = f"{fmt}_compress"
    if control and (root, fmt) not in _controlled:
        _symbol(name, control, root)
        src = _source_of(name, root)
        with open(src) as f:
            if CONTROL not in f.read():
                raise ValueError(
                    f"no control encoder for format {fmt!r}: "
                    f"{os.path.relpath(src, root)} takes no notice of "
                    f"{CONTROL}")
        _controlled[root, fmt] = src
    n = len(data)
    # covers every format's worst case: LZNT1's 2 bytes a 4 KiB chunk,
    # Xpress Huffman's 256-byte table and end word a 64 KiB block
    return _call(name, data, 2 * n + 264 * (n // 65536 + 1) + 64, control,
                 root)


def lznt1_compress(data: bytes, control: bool = False) -> bytes:
    """One LZNT1 stream of 4 KiB chunks, each compressed or stored raw."""
    return compress("lznt1", data, control)


def lznt1_decompress(stream: bytes, cap: int) -> bytes:
    return _call("lznt1_decompress", stream, cap)


def xh_compress(data: bytes, control: bool = False) -> bytes:
    """One Xpress Huffman stream, one block a 64 KiB of ``data``."""
    return compress("xpress_huff", data, control)


def xh_decompress(stream: bytes, out_len: int) -> bytes:
    return _call("xh_decompress", stream, out_len)

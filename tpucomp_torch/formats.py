"""Compression format identifiers and the codec registry, as
``tpucomp.formats``.

The numeric values mirror the Windows ``COMPRESSION_FORMAT_*`` constants.

The registry maps a :class:`Format` to backend implementations, each a
``(compress, decompress)`` pair.  :mod:`tpucomp_torch._register` fills it
when the package is imported:

* ``"device"`` — the port's codecs (:mod:`tpucomp_torch.codecs`): the
  hand-written CUDA kernels on a CUDA device, their plain PyTorch
  versions on the CPU; tpucomp's ``"tpu"``.
* ``"cpu"``    — the port's copy of the native C codec
  (:mod:`tpucomp_torch._native`), built at first use.
* ``"oracle"`` — the port's copy of the pure-Python spec codecs
  (:mod:`tpucomp_torch.oracle`).

A caller may :func:`register` a backend of its own; every entry point of
:mod:`tpucomp_torch.api` reaches it through ``backend=``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from .errors import UnsupportedFormatError


class Format(enum.IntEnum):
    NONE = 0
    DEFAULT = 1  # Windows alias: engine default == LZNT1
    LZNT1 = 2
    XPRESS = 3
    XPRESS_HUFF = 4
    LZX = 5  # descoped: incomplete in the reference


def canonical(fmt: "Format | int | str") -> Format:
    """Normalize a format spec (enum / int / name string) to a Format."""
    if isinstance(fmt, str):
        try:
            fmt = Format[fmt.upper().replace("-", "_")]
        except KeyError:
            raise UnsupportedFormatError(f"unknown format name: {fmt!r}")
    fmt = Format(fmt)
    if fmt == Format.DEFAULT:
        fmt = Format.LZNT1
    return fmt


@dataclass
class CodecEntry:
    """Per-format registry entry: one callable pair per backend."""

    fmt: Format
    # backend -> (compress, decompress); signatures:
    #   compress(data: bytes, **opts) -> bytes
    #   decompress(data: bytes, out_len: Optional[int], **opts) -> bytes
    backends: Dict[str, tuple] = field(default_factory=dict)
    max_compressed_size: Optional[Callable[[int], int]] = None
    streaming: bool = True

    def get(self, backend: str):
        if backend not in self.backends:
            raise UnsupportedFormatError(
                f"format {self.fmt.name} has no {backend!r} backend "
                f"(available: {sorted(self.backends)})"
            )
        return self.backends[backend]


_REGISTRY: Dict[Format, CodecEntry] = {}


def register(
    fmt: Format,
    backend: str,
    compress,
    decompress,
    *,
    max_compressed_size=None,
    streaming: bool = True,
) -> None:
    entry = _REGISTRY.setdefault(fmt, CodecEntry(fmt))
    entry.backends[backend] = (compress, decompress)
    if max_compressed_size is not None:
        entry.max_compressed_size = max_compressed_size
    entry.streaming = entry.streaming and streaming


def lookup(fmt: "Format | int | str") -> CodecEntry:
    fmt = canonical(fmt)
    if fmt not in _REGISTRY:
        raise UnsupportedFormatError(f"format {fmt.name} is not registered")
    return _REGISTRY[fmt]


def registered_formats():
    return sorted(_REGISTRY)

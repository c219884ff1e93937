"""Compression format identifiers: the ``Format`` enum and ``canonical()``
of ``tpucomp.formats``.

The numeric values mirror the Windows ``COMPRESSION_FORMAT_*`` constants.
The codec registry of ``tpucomp.formats`` is not carried over: the port
dispatches on the format in :mod:`tpucomp_torch.api`.
"""

from __future__ import annotations

import enum

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

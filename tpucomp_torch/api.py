"""Public one-shot and batched calls.

Counterparts of ``tpucomp.compress`` / ``decompress`` (``backend="tpu"``),
``compress_batch``, ``decompress_batch`` and ``max_compressed_size``.
Every call that computes takes a ``device``; the default is ``"cuda"``,
and asking for CUDA where it is not available raises.  Ported so far:
LZNT1 and plain Xpress encode and decode (one-shot and batched; Xpress
one-shot decode up to 64 KiB, one-shot encode of any length as one
stream), and Xpress Huffman encode and decode (one-shot, multi-block
streams included, and batched); any other format raises
:class:`UnsupportedFormatError`.  Archives of many units, sharded over
the GPUs of a ``torch.distributed`` group (one process each), are
:mod:`tpucomp_torch.dist`'s, as tpucomp sends device-batched work to
``tpucomp.dist``.
"""

from __future__ import annotations

from typing import Optional

from . import formats
from .codecs import lznt1, xpress, xpress_huff
from .errors import ArgError, UnsupportedFormatError
from .formats import Format


def _not_ported(fmt: Format, call: str):
    return UnsupportedFormatError(
        f"{call} of format {fmt.name} is not ported to tpucomp_torch yet "
        "(LZNT1, XPRESS and XPRESS_HUFF compress, compress_batch, "
        "decompress and decompress_batch are)")


def compress(fmt, data: bytes, *, device="cuda") -> bytes:
    """One-shot compress of ``data`` on ``device``: the same stream as
    ``tpucomp.compress(fmt, data, backend="tpu")``.  XPRESS over 64 KiB is
    one stream of tpucomp's single-stream encoder
    (:func:`tpucomp_torch.codecs.xpress.compress_stream`)."""
    if data is None:
        raise ArgError("data must be bytes-like")
    fmt = formats.canonical(fmt)
    if fmt == Format.LZNT1:
        return lznt1.compress(data, device=device)
    if fmt == Format.XPRESS:
        return xpress.compress(data, device=device)
    if fmt == Format.XPRESS_HUFF:
        return xpress_huff.compress(data, device=device)
    raise _not_ported(fmt, "compress")


def compress_batch(fmt, units, *, unit_size: Optional[int] = None,
                   device="cuda") -> list:
    """Compress independent units in one device batch: one stream per
    unit, as ``tpucomp.compress_batch``.

    LZNT1: a unit is one chunk of at most 4096 bytes (a longer one raises
    :class:`ArgError`); an empty unit gives ``b""``.  ``unit_size`` is
    accepted for parity with tpucomp and not used.

    XPRESS and XPRESS_HUFF: units of at most ``unit_size`` bytes
    (default 65536, the widest; a longer unit raises :class:`ArgError`),
    one row each.
    """
    fmt = formats.canonical(fmt)
    if fmt == Format.LZNT1:
        return lznt1.compress_units(list(units), device=device)
    if fmt == Format.XPRESS:
        return xpress.compress_units(list(units), unit_size or xpress.UNIT,
                                     device=device)
    if fmt == Format.XPRESS_HUFF:
        return xpress_huff.compress_units(
            list(units), unit_size or xpress_huff.BLOCK, device=device)
    raise _not_ported(fmt, "compress_batch")


def max_compressed_size(fmt, n: int) -> int:
    """Worst-case compressed size of ``n`` bytes, as tpucomp's."""
    if n < 0:
        raise ArgError("n must be non-negative")
    fmt = formats.canonical(fmt)
    if fmt == Format.LZNT1:
        return lznt1.max_compressed_size(n)
    if fmt == Format.XPRESS:
        return xpress.max_compressed_size(n)
    if fmt == Format.XPRESS_HUFF:
        return xpress_huff.max_compressed_size(n)
    raise _not_ported(fmt, "max_compressed_size")


def decompress(fmt, data: bytes, out_len: Optional[int] = None, *,
               device="cuda") -> bytes:
    """One-shot decompress of one stream on ``device``.

    LZNT1 is self-terminating; ``out_len`` truncates the result, and a
    stream shorter than ``out_len`` raises :class:`DataError`.  XPRESS
    needs ``out_len`` (at most 65536; :class:`ArgError` without it).
    XPRESS_HUFF needs ``out_len`` too (:class:`ArgError` without it); the
    stream may hold any number of 64 KiB blocks, and its matches may
    reach back across them.
    """
    if data is None:
        raise ArgError("data must be bytes-like")
    fmt = formats.canonical(fmt)
    if fmt == Format.LZNT1:
        return lznt1.decompress(data, out_len, device=device)
    if fmt == Format.XPRESS:
        return xpress.decompress(data, out_len, device=device)
    if fmt == Format.XPRESS_HUFF:
        return xpress_huff.decompress(data, out_len, device=device)
    raise _not_ported(fmt, "decompress")


def decompress_batch(fmt, streams, out_lens=None, *,
                     unit_size: Optional[int] = None, device="cuda") -> list:
    """Decompress independent unit streams in one device batch.

    LZNT1: ``out_lens`` and ``unit_size`` are accepted for parity with
    tpucomp and not needed (units are self-terminating); a malformed unit
    raises :class:`ArgError`, as tpucomp's does.

    XPRESS_HUFF: each stream is one block; ``out_lens`` (required, else
    :class:`ArgError`) gives the decoded lengths, at most ``unit_size``
    (default 65536, a multiple of 512).  A malformed unit raises
    :class:`DataError`.

    XPRESS: as XPRESS_HUFF, with ``unit_size`` any width up to 65536.
    """
    fmt = formats.canonical(fmt)
    if fmt == Format.LZNT1:
        return lznt1.decompress_units(list(streams), device=device)
    if fmt == Format.XPRESS:
        if out_lens is None:
            raise ArgError("XPRESS: out_lens is required")
        return xpress.decompress_units(list(streams), list(out_lens),
                                       unit_size or xpress.UNIT,
                                       device=device)
    if fmt == Format.XPRESS_HUFF:
        if out_lens is None:
            raise ArgError("XPRESS_HUFF: out_lens is required")
        return xpress_huff.decompress_units(
            list(streams), list(out_lens), unit_size or xpress_huff.BLOCK,
            device=device)
    raise _not_ported(fmt, "decompress_batch")

"""Public one-shot and batched decode calls.

Counterparts of ``tpucomp.decompress(..., backend="tpu")`` and
``tpucomp.decompress_batch``.  Every call takes a ``device``; the default
is ``"cuda"``, and asking for CUDA where it is not available raises.
Only LZNT1 is ported so far; any other format raises
:class:`UnsupportedFormatError`.
"""

from __future__ import annotations

from typing import Optional

from . import formats
from .codecs import lznt1
from .errors import ArgError, UnsupportedFormatError
from .formats import Format


def _lznt1_only(fmt) -> None:
    fmt = formats.canonical(fmt)
    if fmt != Format.LZNT1:
        raise UnsupportedFormatError(
            f"format {fmt.name} is not ported to tpucomp_torch yet "
            "(only LZNT1 decode is)")


def decompress(fmt, data: bytes, out_len: Optional[int] = None, *,
               device="cuda") -> bytes:
    """One-shot decompress of one stream on ``device``.

    LZNT1 is self-terminating; ``out_len`` truncates the result, and a
    stream shorter than ``out_len`` raises :class:`DataError`.
    """
    if data is None:
        raise ArgError("data must be bytes-like")
    _lznt1_only(fmt)
    return lznt1.decompress(data, out_len, device=device)


def decompress_batch(fmt, streams, out_lens=None, *, device="cuda") -> list:
    """Decompress independent unit streams in one device batch.

    ``out_lens`` is accepted for parity with tpucomp and not needed: LZNT1
    units are self-terminating.  A malformed unit raises :class:`ArgError`,
    as tpucomp's does.
    """
    _lznt1_only(fmt)
    return lznt1.decompress_units(list(streams), device=device)

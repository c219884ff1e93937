"""Public one-shot, batched and streaming calls.

Counterparts of ``tpucomp.compress`` / ``decompress``,
``compress_batch``, ``decompress_batch``, ``max_compressed_size`` and the
streaming ``Compressor`` / ``Decompressor`` (the reference library's
``ms_deflate*`` / ``ms_inflate*``).  Archives of many units, sharded over
the GPUs of a ``torch.distributed`` group (one process each), are
:mod:`tpucomp_torch.dist`'s, as tpucomp sends device-batched work to
``tpucomp.dist``.

Backends (``backend=`` of ``compress``, ``decompress``, ``Compressor``
and ``Decompressor``), each picked from the codec registry
(:mod:`tpucomp_torch.formats`) by ``formats.lookup(fmt).get(backend)``,
as tpucomp's are:

* ``"device"`` (the default): the port's kernels on ``device`` (default
  ``"cuda"``; asking for CUDA where it is not available raises), tpucomp's
  ``backend="tpu"``.  Xpress one-shot decode covers streams of at most
  64 KiB, as tpucomp's device backend does.  ``device=`` reaches this
  backend alone.
* ``"cpu"``: the port's copy of the native C codec
  (:mod:`tpucomp_torch._native`), built at first use; a failed build
  raises.
* ``"oracle"``: the port's copy of the pure-Python spec codecs
  (:mod:`tpucomp_torch.oracle`).
* ``"auto"``: the first of ``"cpu"``, ``"oracle"`` that is registered,
  tpucomp's preference order: ``"cpu"``.
* any backend a caller registers with :func:`formats.register`.  The
  LZNT1 classes use its ``compress`` / ``decompress``; the Xpress and XH
  classes refuse it with :class:`ArgError`, as they refuse
  ``"device"``: their window-carry engines are the host codecs'.

The default differs from tpucomp's, whose ``"auto"`` picks a host codec:
the port's entry points run on the card unless the caller asks for
something else.  An unregistered format or backend raises
:class:`UnsupportedFormatError`.
"""

from __future__ import annotations

import functools
from typing import Optional

from . import formats
from .codecs import lznt1, xpress, xpress_huff
from .errors import ArgError, DataError, UnsupportedFormatError
from .formats import Format
from .stats import count, span
from .util import resolve_device

_BACKEND_PREFERENCE = ("cpu", "oracle")


def _not_ported(fmt: Format, call: str):
    return UnsupportedFormatError(
        f"{call} of format {fmt.name} is not ported to tpucomp_torch "
        "(tpucomp registers no codec for it either; LZNT1, XPRESS and "
        "XPRESS_HUFF are ported)")


def _lookup(fmt, call: str) -> formats.CodecEntry:
    fmt = formats.canonical(fmt)
    try:
        return formats.lookup(fmt)
    except UnsupportedFormatError:
        raise _not_ported(fmt, call) from None


def _resolve_backend(entry: formats.CodecEntry, backend: str) -> str:
    if backend != "auto":
        return backend
    for b in _BACKEND_PREFERENCE:
        if b in entry.backends:
            return b
    return next(iter(entry.backends))


def _oracle(fmt: Format):
    """The port's oracle module of ``fmt``."""
    from . import oracle

    return {Format.LZNT1: oracle.lznt1, Format.XPRESS: oracle.xpress,
            Format.XPRESS_HUFF: oracle.xpress_huff}[fmt]


def _pick(entry: formats.CodecEntry, backend: str, device):
    """The resolved backend's name and its (compress, decompress) pair:
    ``compress(data, **opts)``, ``decompress(data, out_len, **opts)``,
    with ``device`` bound on ``"device"``."""
    resolved = _resolve_backend(entry, backend)
    comp, decomp = entry.get(resolved)
    if resolved == "device":
        comp = functools.partial(comp, device=device)
        decomp = functools.partial(decomp, device=device)
    return resolved, comp, decomp


def compress(fmt, data: bytes, *, backend: str = "device", device="cuda",
             **opts) -> bytes:
    """One-shot compress (reference: ``ms_compress``): the same stream as
    ``tpucomp.compress(fmt, data, backend=...)`` with ``"device"`` read as
    tpucomp's ``"tpu"``.  On ``"device"``, XPRESS over 64 KiB is one
    stream of tpucomp's single-stream encoder
    (:func:`tpucomp_torch.codecs.xpress.compress_stream`).  ``opts`` go to
    the backend's encoder (the oracle's XPRESS_HUFF takes
    ``cross_block=True``)."""
    if data is None:
        raise ArgError("data must be bytes-like")
    with span("api.compress", "call"):
        _, comp, _ = _pick(_lookup(fmt, "compress"), backend, device)
        data = bytes(data)
        out = comp(data, **opts)
        count("bytes_in", len(data))
        count("bytes_out", len(out))
        return out


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
    with span("api.compress_batch", "call"):
        units = list(units)
        if fmt == Format.LZNT1:
            out = lznt1.compress_units(units, device=device)
        elif fmt == Format.XPRESS:
            out = xpress.compress_units(units, unit_size or xpress.UNIT,
                                        device=device)
        elif fmt == Format.XPRESS_HUFF:
            out = xpress_huff.compress_units(
                units, unit_size or xpress_huff.BLOCK, device=device)
        else:
            raise _not_ported(fmt, "compress_batch")
        count("bytes_in", sum(map(len, units)))
        count("bytes_out", sum(map(len, out)))
        return out


def max_compressed_size(fmt, n: int) -> int:
    """Worst-case compressed size of ``n`` bytes: the registered bound
    (the oracle's), as tpucomp's."""
    if n < 0:
        raise ArgError("n must be non-negative")
    entry = _lookup(fmt, "max_compressed_size")
    if entry.max_compressed_size is None:
        raise ArgError(f"format {entry.fmt.name} has no size bound")
    return entry.max_compressed_size(n)


def decompress(fmt, data: bytes, out_len: Optional[int] = None, *,
               backend: str = "device", device="cuda", **opts) -> bytes:
    """One-shot decompress of one stream (reference: ``ms_decompress``),
    as ``tpucomp.decompress(fmt, data, out_len, backend=...)``.

    LZNT1 is self-terminating; ``out_len`` truncates the result, and a
    stream shorter than ``out_len`` raises :class:`DataError`.  XPRESS
    needs ``out_len`` (:class:`ArgError` without it; on ``"device"`` at
    most 65536).  XPRESS_HUFF needs ``out_len`` too (:class:`ArgError`
    without it); the stream may hold any number of 64 KiB blocks, and its
    matches may reach back across them.
    """
    if data is None:
        raise ArgError("data must be bytes-like")
    with span("api.decompress", "call"):
        _, _, decomp = _pick(_lookup(fmt, "decompress"), backend, device)
        data = bytes(data)
        out = decomp(data, out_len, **opts)
        count("bytes_in", len(data))
        count("bytes_out", len(out))
        return out


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
    with span("api.decompress_batch", "call"):
        streams = list(streams)
        if fmt == Format.LZNT1:
            out = lznt1.decompress_units(streams, device=device)
        elif fmt == Format.XPRESS:
            if out_lens is None:
                raise ArgError("XPRESS: out_lens is required")
            out = xpress.decompress_units(streams, list(out_lens),
                                          unit_size or xpress.UNIT,
                                          device=device)
        elif fmt == Format.XPRESS_HUFF:
            if out_lens is None:
                raise ArgError("XPRESS_HUFF: out_lens is required")
            out = xpress_huff.decompress_units(
                streams, list(out_lens), unit_size or xpress_huff.BLOCK,
                device=device)
        else:
            raise _not_ported(fmt, "decompress_batch")
        count("bytes_in", sum(map(len, streams)))
        count("bytes_out", sum(map(len, out)))
        return out


def _lznt1_complete_chunks(buf: bytearray):
    """The complete chunks at the head of an LZNT1 stream buffer, each its
    header and payload, and whether a header 0 (the end) follows them."""
    chunks, i = [], 0
    while len(buf) - i >= 2:
        header = buf[i] | (buf[i + 1] << 8)
        if header == 0:
            return chunks, True
        size = (header & 0xFFF) + 1
        if len(buf) - i < 2 + size:
            break
        chunks.append(bytes(buf[i:i + 2 + size]))
        i += 2 + size
    return chunks, False


class Compressor:
    """Streaming compressor (reference: ``ms_deflate_init`` /
    ``ms_deflate`` / ...), tpucomp's ``Compressor`` line for line.

    LZNT1 is chunk-local by format: the input is cut into units of
    ``unit_size`` (a multiple of 4096; default 4096) as they fill, and the
    stream equals one-shot ``compress`` of the whole input on the same
    backend.  All the complete units of one ``compress()`` feed go through
    one encode call (on ``"device"``: one batch on the card), and the
    tail through one more at ``flush()``.

    XPRESS and XPRESS_HUFF carry the match window across feeds: the
    output is one standard stream of the format, made by a window-carry
    engine on ``"cpu"`` (the native C engines: XPRESS_HUFF equals
    one-shot native ``compress`` of the concatenation, 64 KiB
    block-local; XPRESS equals it except across a match deferred past 1
    MiB) or ``"oracle"`` (the spec engines: XPRESS_HUFF with the
    cross-block window, equal to the oracle's ``compress(data,
    cross_block=True)``).  ``"device"`` has no such engine, as tpucomp's
    ``"tpu"`` has none: it raises :class:`ArgError` (use
    :func:`compress_batch` or :mod:`tpucomp_torch.dist`).
    XPRESS_HUFF's ``unit_size`` must be a multiple of 65536.
    """

    _UNIT = {
        Format.LZNT1: 4096,
        Format.XPRESS: 65536,
        Format.XPRESS_HUFF: 65536,
    }

    def __init__(self, fmt, *, backend: str = "device",
                 unit_size: Optional[int] = None, device="cuda"):
        self.fmt = formats.canonical(fmt)
        entry = _lookup(self.fmt, "Compressor")
        resolved = _resolve_backend(entry, backend)
        if resolved == "device":
            device = resolve_device(device)
        _, self._compress, _ = _pick(entry, resolved, device)
        self.backend = resolved
        self.unit_size = unit_size or self._UNIT[self.fmt]
        if self.fmt == Format.LZNT1 and self.unit_size % 4096 != 0:
            raise ArgError("LZNT1 streaming unit must be a multiple of 4096")
        if (self.fmt == Format.XPRESS_HUFF
                and self.unit_size % 65536 != 0):
            raise ArgError(
                "XPRESS_HUFF streaming unit must be a multiple of 64 KiB")
        self._engine = None
        if self.fmt in (Format.XPRESS, Format.XPRESS_HUFF):
            if resolved == "cpu":
                from ._native import NativeStreamCompressor

                self._engine = NativeStreamCompressor(self.fmt)
            elif resolved == "oracle":
                self._engine = _oracle(self.fmt).StreamCompressor()
            else:
                raise ArgError(
                    f"backend={resolved!r} does not support streaming "
                    "compression; use compress_batch/tpucomp_torch.dist "
                    "for device batching, or backend='cpu'/'oracle'")
        self._buf = bytearray()
        self._finished = False
        self.total_in = 0
        self.total_out = 0

    def compress(self, data: bytes) -> bytes:
        if self._finished:
            raise ArgError("compressor already flushed")
        self.total_in += len(data)
        if self._engine is not None:
            out = self._engine.compress(bytes(data))
            self.total_out += len(out)
            return out
        self._buf += bytes(data)
        out = b""
        whole = len(self._buf) // self.unit_size * self.unit_size
        if whole:
            # the units are whole 4 KiB chunks, each framed on its own:
            # one call of their concatenation gives tpucomp's bytes
            units = bytes(self._buf[:whole])
            del self._buf[:whole]
            out = self._compress(units)
        self.total_out += len(out)
        return out

    def flush(self) -> bytes:
        if self._finished:
            return b""
        self._finished = True
        if self._engine is not None:
            out = self._engine.flush()
            self.total_out += len(out)
            return out
        out = b""
        if self._buf:
            out = self._compress(bytes(self._buf))
            self._buf.clear()
        self.total_out += len(out)
        return out


class Decompressor:
    """Streaming decompressor (reference: ``ms_inflate_init`` /
    ``ms_inflate`` / ...), tpucomp's ``Decompressor`` line for line.

    LZNT1 needs no size: feed any slices of a stream, and each feed gives
    the output of the chunks it completes, decoded in one call (on
    ``"device"``: one batch on the card).  A header 0 ends the stream and
    drops what is buffered.  A malformed chunk raises :class:`DataError`
    with none of that feed's output; the chunks up to and including it
    are consumed.  ``flush()`` decodes what is left (a partial chunk
    raises :class:`DataError`).

    XPRESS and XPRESS_HUFF carry no size header: give ``out_len``, the
    total decoded size, for a window-carry engine on ``"cpu"`` or
    ``"oracle"`` (``"device"`` has none and raises :class:`ArgError`, as
    tpucomp's ``"tpu"``), or ``unit_out_lens`` for unit-framed streams
    (archives), each decoded by :meth:`decompress_unit` through the
    backend's one-shot ``decompress``.  ``decompress()`` without
    ``out_len`` raises :class:`ArgError` for them.
    """

    def __init__(self, fmt, *, backend: str = "device", out_len=None,
                 unit_out_lens=None, device="cuda"):
        self.fmt = formats.canonical(fmt)
        entry = _lookup(self.fmt, "Decompressor")
        resolved = _resolve_backend(entry, backend)
        if resolved == "device":
            device = resolve_device(device)
        _, _, self._decompress = _pick(entry, resolved, device)
        self.backend = resolved
        self.device = device
        self._buf = bytearray()
        self.total_in = 0
        self.total_out = 0
        self._engine = None
        if (self.fmt in (Format.XPRESS, Format.XPRESS_HUFF)
                and out_len is not None):
            if resolved == "cpu":
                from ._native import NativeStreamDecompressor

                self._engine = NativeStreamDecompressor(self.fmt, out_len)
            elif resolved == "oracle":
                self._engine = _oracle(self.fmt).StreamDecompressor(out_len)
            else:
                raise ArgError(
                    f"backend={resolved!r} does not support streaming "
                    "decompression; use decompress_batch/tpucomp_torch.dist, "
                    "or backend='cpu'/'oracle'")
        if (self.fmt != Format.LZNT1 and out_len is None
                and unit_out_lens is None):
            raise ArgError(
                f"{self.fmt.name} streaming decompression requires out_len "
                "(standard stream) or unit_out_lens (unit-framed feed)")
        self._unit_out_lens = list(unit_out_lens or [])

    def decompress(self, data: bytes) -> bytes:
        if self._engine is not None:
            out = self._engine.decompress(bytes(data))
            self.total_in += len(data)
            self.total_out += len(out)
            return out
        self._buf += bytes(data)
        self.total_in += len(data)
        if self.fmt != Format.LZNT1:
            raise ArgError(
                "Xpress streaming decode without out_len requires "
                "unit-delimited feed; use decompress_unit()")
        out = self._lznt1_chunks()
        self.total_out += len(out)
        return out

    def _lznt1_chunks(self) -> bytes:
        """Decode and consume every complete chunk buffered; clear the
        buffer at a header 0."""
        chunks, end = _lznt1_complete_chunks(self._buf)
        if self.backend == "device":
            out, bad = lznt1.decompress_chunks(chunks, device=self.device)
            if bad is not None:
                del self._buf[:sum(map(len, chunks[:bad + 1]))]
                raise DataError("LZNT1: malformed stream")
            del self._buf[:sum(map(len, chunks))]
        else:
            out = bytearray()
            for chunk in chunks:
                del self._buf[:len(chunk)]
                out += self._decompress(chunk, None)
            out = bytes(out)
        if end:
            self._buf.clear()
        return out

    def decompress_unit(self, unit: bytes) -> bytes:
        """Decode one complete compressed unit (Xpress formats)."""
        if not self._unit_out_lens:
            raise ArgError("no unit_out_lens remaining")
        out_len = self._unit_out_lens.pop(0)
        out = self._decompress(bytes(unit), out_len)
        self.total_in += len(unit)
        self.total_out += len(out)
        return out

    def flush(self) -> bytes:
        if self._engine is not None:
            out = self._engine.flush()
            self.total_out += len(out)
            return out
        if self.fmt == Format.LZNT1 and self._buf:
            out = self._decompress(bytes(self._buf), None)
            self._buf.clear()
            self.total_out += len(out)
            return out
        return b""

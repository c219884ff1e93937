"""Xpress Huffman batched decode, block-parallel, on PyTorch tensors.

Counterpart of the decode half of ``tpucomp/codecs/xpress_huff.py``, the
path ``decompress_units`` takes.  One row of a batch is one
single-block unit stream: a 256-byte table of 512 code lengths, then the
body.  The pipeline:

  tables (plain torch)  -> canonical per-level limits and the rank->symbol
                           table of every row (kernels.huffman)
  parse (kernel)        -> token records, one slot per record
  fill (kernel)         -> per output byte: its token's literal or offset,
                           and the token's start
  periodic fold         -> a byte past the first period of an overlapping
                           match copies from that period
  near resolve (kernel) -> copies inside each 512-byte segment resolved,
                           the rest tagged with their absolute source
  far rounds (kernels)  -> the 4 KiB segment level, the archive probes
                           (``fast_resolve``), the full-row level

tpucomp buckets the units by substep tier, body size and rank cap,
because each is a compile-time shape for XLA and Mosaic.  Here all units
decode in one batch: the parse takes each row's substep count ``ss[n]``
as an input, and every row gets the count tpucomp's bucket gives it (a
row's tier depends on its own table alone).  That matters: the leftover
check, which sets err, depends on it.  The rank cap only bounds the
length of tpucomp's rank->symbol scan; the parse here indexes the table
directly and needs none.

The one-shot multi-block decode (tpucomp's ``decompress``) is not ported
yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import ArgError, DataError
from ..kernels.common import far_rounds
from ..kernels.fill import fill_records_delta2
from ..kernels.huffman import (  # noqa: F401 (NUM_SYMBOLS: tpucomp's name)
    NUM_SYMBOLS,
    canonical_from_lengths,
    level_tables,
    rank_to_symbol_table,
    unpack_table,
)
from ..kernels.resolve import SEG, resolve_near
from ..kernels.xh_parse import COPY_BIT, xh_parse
from ..util import resolve_device

BLOCK = 65536
TABLE = 256  # bytes of code lengths before the body

# min code length guaranteed by each substep tier (tpucomp's _BUCKET_MCL)
_BUCKET_MCL = {3: 8, 5: 4, 9: 2, 17: 1}


def max_payload(u: int) -> int:
    """Worst-case single-block payload: table + 2 bytes/input + slack."""
    return TABLE + 2 * u + 16


def _min_code_len(streams) -> int:
    """Smallest code length used across the blocks' tables (host peek)."""
    m = 15
    for s in streams:
        tb = np.frombuffer(bytes(s[:TABLE]), np.uint8)
        lens = np.concatenate([tb & 0xF, tb >> 4])
        used = lens[lens > 0]
        if used.size:
            m = min(m, int(used.min()))
    return m


def _substeps_for(mcl: int) -> int:
    """Symbols one refill can complete: ceil(16 / min_len) + 1, rounded up
    to tpucomp's tiers 3, 5, 9 and 17."""
    need = -(-16 // max(mcl, 1)) + 1
    for cap in (3, 5, 9, 17):
        if need <= cap:
            return cap
    return 17


def batch_from_numpy(payload: np.ndarray, plen: np.ndarray,
                     out_len: np.ndarray, ss: np.ndarray, device="cuda"):
    """Move the numpy batch that tpucomp's decoder takes (payload int32
    [N, P] with P >= 256, plen and out_len int32 [N]) plus each row's
    substep count ``ss`` int32 [N] onto ``device``.  The payload lands as
    uint8 (its values are bytes)."""
    dev = resolve_device(device)
    payload = np.asarray(payload)
    N = payload.shape[0]
    arrays = [np.asarray(a, np.int32) for a in (plen, out_len, ss)]
    if payload.ndim != 2 or payload.shape[1] < TABLE \
            or any(a.shape != (N,) for a in arrays):
        raise ArgError(f"expected [N, P >= {TABLE}] and three [N] arrays")
    if N and (arrays[0].min() < 0 or arrays[0].max() > payload.shape[1]):
        raise ArgError(f"plen must lie in [0, {payload.shape[1]}]")
    return (torch.from_numpy(payload.astype(np.uint8)).to(dev),
            *(torch.from_numpy(a).to(dev) for a in arrays))


def decode_batch(payload: torch.Tensor, plen: torch.Tensor,
                 out_len: torch.Tensor, ss: torch.Tensor, U: int,
                 fast_resolve: bool = False):
    """Decode a batch of single-block XH unit streams (the mode path of
    tpucomp's ``_decode_impl``).

    Args (all on one device, e.g. from :func:`batch_from_numpy`):
      payload: uint8 [N, P], each stream, zero-padded.
      plen:    int32 [N], stream length in bytes.
      out_len: int32 [N], decoded length, <= U.
      ss:      int32 [N], the substep tier of each row's table.
      U:       output width of a row, a multiple of 512 up to 65536.
      fast_resolve: run the archive value-chase probes before the last far
               level (for ``xh_compress_resolved`` streams; right for any).

    Returns:
      out: uint8 [N, U] decoded bytes (tpucomp returns int32; the values
           are equal), zero past out_len
      err: bool [N] malformed-stream flag; the bytes of a row with err
           set are meaningless
    """
    return _records_to_output(*parse_batch(payload, plen, out_len, ss, U),
                              out_len, U, fast_resolve)


def parse_inputs(payload, plen, out_len, ss):
    """Each row's canonical tables: the arguments of :func:`xh_parse` but
    for U, (body, blen, out_len, ss, lim15, rbf, sym_by_rank)."""
    lengths = unpack_table(payload)
    _, fc, br, lim = canonical_from_lengths(lengths)
    lim15, rbf = level_tables(fc, br, lim)
    return (payload[:, TABLE:].contiguous(), plen - TABLE, out_len, ss,
            lim15, rbf, rank_to_symbol_table(lengths))


def parse_batch(payload, plen, out_len, ss, U: int):
    """The head of :func:`decode_batch`: the tables, then the parse.
    Returns :func:`xh_parse`'s (rec_pos, rec_val, p_final, err)."""
    return xh_parse(*parse_inputs(payload, plen, out_len, ss), U)


def _records_to_output(rec_pos, rec_val, p_final, errk, out_len, U,
                       fast_resolve=False):
    """Decode tail: token records -> output bytes (tpucomp's
    ``_records_to_output``, mode path)."""
    # tpucomp's keep bound (8 * body / min code length + 8) never binds:
    # every record is one decoded symbol of at least that many bits.  Here
    # a row has at most U record slots, so keep = U cannot overflow either.
    vpack, tokpos, ovf = fill_records_delta2(rec_pos, rec_val, U, keep=U)
    err = (errk != 0) | (ovf != 0) | (p_final < out_len)
    is_copy, disp, litv = near_inputs(vpack, tokpos)
    out = far_rounds(resolve_near(is_copy, disp, litv), U, SEG,
                     fast=fast_resolve)
    j = torch.arange(U, dtype=torch.int32, device=out.device)
    out = torch.where(j < out_len[:, None], out, 0).to(torch.uint8)
    return out, err


def near_inputs(vpack: torch.Tensor, tokpos: torch.Tensor):
    """The filled planes -> the near walk's (is_copy, disp, litv).

    Periodic fold: byte k >= d into an overlapping match copies the
    match's own first period (src = tokpos + k mod d) instead of chasing a
    depth-k/d chain; [MS-XCA] overlapping copies make both sources equal.
    """
    is_copy = (vpack & COPY_BIT) != 0
    disp = vpack & (COPY_BIT - 1)
    j = torch.arange(vpack.shape[1], dtype=torch.int32, device=vpack.device)
    rel = j - tokpos
    dispc = disp.clamp(min=1)
    disp = torch.where(is_copy & (rel >= dispc), rel - torch.fmod(rel, dispc),
                       disp)
    return is_copy, disp, torch.where(is_copy, 0, vpack & 0x1FF)


def pack_units(streams, out_lens, unit_size: int, device):
    """Unit streams -> a batch on ``device``, one row per unit, with each
    row's substep tier.  Raises :class:`ArgError` for an out_len past
    ``unit_size`` and :class:`DataError` for a stream longer than any
    block of ``unit_size`` bytes encodes to."""
    if any(o > unit_size for o in out_lens):
        raise ArgError("out_len larger than unit_size")
    cap = max_payload(unit_size)
    if any(len(s) > cap for s in streams):
        raise DataError("XpressHuff: unit stream longer than a block's "
                        "largest encoding")
    N = len(streams)
    P = max(TABLE, max(len(s) for s in streams))
    P = -(-P // 16) * 16
    payload = np.zeros((N, P), np.uint8)
    plen = np.zeros(N, np.int32)
    ss = np.zeros(N, np.int32)
    for i, s in enumerate(streams):
        a = np.frombuffer(bytes(s), np.uint8)
        payload[i, :len(a)] = a
        plen[i] = len(a)
        ss[i] = _substeps_for(_min_code_len([s]))
    return (torch.from_numpy(payload).to(device),
            torch.from_numpy(plen).to(device),
            torch.from_numpy(np.asarray(out_lens, np.int32)).to(device),
            torch.from_numpy(ss).to(device))


def decompress_units(streams, out_lens, unit_size=BLOCK, fast_resolve=False,
                     *, device="cuda") -> list:
    """Decompress a batch of independent single-block XH unit streams, all
    in one device batch.

    ``out_lens[i]`` is unit i's decoded length, at most ``unit_size``
    (:class:`ArgError` otherwise).  A malformed unit raises
    :class:`DataError`.  ``fast_resolve`` takes the archive path of
    tpucomp's resolved manifests (see :func:`decode_batch`).
    """
    if not streams:
        return []
    dev = resolve_device(device)
    if unit_size <= 0 or unit_size > BLOCK or unit_size % SEG:
        raise ArgError(f"XPRESS_HUFF unit_size must be a multiple of {SEG} "
                       f"up to {BLOCK}, got {unit_size}")
    streams = [bytes(s) for s in streams]
    out_lens = [int(o) for o in out_lens]
    if len(out_lens) != len(streams):
        raise ArgError("one out_len per stream is required")
    batch = pack_units(streams, out_lens, unit_size, dev)
    out, err = decode_batch(*batch, unit_size, fast_resolve=fast_resolve)
    if bool(err.any()):
        raise DataError("XpressHuff: malformed unit stream")
    out = out.cpu().numpy()
    return [out[i, :o].tobytes() for i, o in enumerate(out_lens)]

"""Xpress Huffman decode and encode, block-parallel, on PyTorch tensors.

Counterpart of ``tpucomp/codecs/xpress_huff.py``.  One row of a batch is
one single-block stream: a 256-byte table of 512 code lengths, then the
body.  The decode pipeline (the path ``decompress_units`` takes):

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

The encode pipeline (:func:`encode_batch`, tpucomp's ``_encode_impl``),
whose streams equal tpucomp's byte for byte at the same
``MatchFinderConfig``:

  find_matches          -> the plain Xpress match finder (run matcher and
                           row sort kernels) with no window bound
  greedy commit walk (kernel)
  symbols               -> a literal byte, or 256 | offset bits << 4 |
                           length nibble, per committed token
  code tables (kernel)  -> histogram, two-queue Huffman lengths with the
                           15-bit repair, canonical codes
  lookup (kernel)       -> each token's (code, length) by the row gather
  layout                -> the lazy-flush 16-bit word writer in closed
                           form: bit offsets by cumsums, word planes and
                           escape bytes by direct scatters

The one-shot multi-block decode (:func:`decompress`, tpucomp's
``decompress``).  A multi-block stream is a row of blocks, each a table
and a body, and a block's end is found only by decoding it ([MS-XCA]
§2.1); a match may reach up to 64 KiB back into the blocks before it.
Each batch decode (:func:`history_decode`) runs the pipeline above with
two additions, on slices of the stream that start at a block and run up
to ``max_payload(65536)`` bytes on: the parse also checks each offset
against the row's history reach and returns each block's byte span, and
the near walk and far levels run over ``[64 KiB history | block]`` rows
of 131072 bytes, the history's columns literals.  Past 64 KiB the call
first tries the speculative path, as tpucomp:

  Kraft scan (host)     -> every offset whose next 256 bytes are a
                           complete canonical table (at most 512, else
                           the sequential walk below)
  speculative batch     -> every candidate decoded as a full block over an
                           all-zero history: its span and err
  chain walk (host)     -> from offset 0, block after block by span; a
                           link that is no clean candidate (the partial
                           last block) costs one batch decode of its own
  fixpoint passes       -> every block of the chain re-decoded with the
                           block before it as history, until no output
                           changes (one pass without cross-block matches)

and otherwise walks the blocks one batch decode each, each with the last
64 KiB of output as history.  The substep tier of a batch is the largest
of its slices' tiers, as tpucomp's: the leftover check, which sets err,
depends on it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import MatchFinderConfig
from ..errors import ArgError, DataError
from ..kernels.commit import greedy_commit
from ..kernels.common import (
    far_rounds,
    fill_records_delta,
    histogram,
    place_monotone,
    rolled_or,
    scatter_sorted_or,
)
from ..kernels.fill import fill_records_delta2
from ..kernels.gather import gather_rows
from ..kernels.huffman import (
    NUM_SYMBOLS,
    canonical_from_lengths,
    huffman_tables,
    level_tables,
    rank_to_symbol_table,
    unpack_table,
)
from ..kernels.resolve import SEG, resolve_near
from ..kernels.xh_parse import COPY_BIT, xh_parse
from ..stats import count, span
from ..util import (any_set, resolve_device, row_streams, to_device,
                    to_host, unit_rows)

BLOCK = 65536
TABLE = 256  # bytes of code lengths before the body
MIN_MATCH = 3
HIST = BLOCK  # the history a block's matches may reach: the 64 KiB before it
MAX_CANDS = 512  # Kraft candidates past which the speculative path gives up

# min code length guaranteed by each substep tier (tpucomp's _BUCKET_MCL)
_BUCKET_MCL = {3: 8, 5: 4, 9: 2, 17: 1}


def max_payload(u: int) -> int:
    """Worst-case single-block payload: table + 2 bytes/input + slack."""
    return TABLE + 2 * u + 16


def max_compressed_size(n: int) -> int:
    """Worst-case stream size for ``n`` input bytes, the bound of
    ``tpucomp.max_compressed_size`` (the oracle's; tpucomp's codec module
    states the same): a table and 8 bytes of slack per 64 KiB block, 2
    bytes per input byte, 4 more."""
    return max(1, -(-n // BLOCK)) * (TABLE + 8) + 2 * n + 4


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


@span("xh.decode", "compute")
def decode_batch(payload: torch.Tensor, plen: torch.Tensor,
                 out_len: torch.Tensor, ss: torch.Tensor, U: int,
                 fast_resolve: bool = False, *, hist=None, hist_len=None,
                 want_span: bool = False):
    """Decode a batch of single-block XH streams (the mode path of
    tpucomp's ``_decode_impl``; with ``hist`` or ``want_span``, its XLA
    path ``make_decoder(..., want_span=True, with_history=True)``).

    Args (all on one device, e.g. from :func:`batch_from_numpy`):
      payload: uint8 [N, P], each stream, zero-padded.
      plen:    int32 [N], stream length in bytes.
      out_len: int32 [N], decoded length, <= U.
      ss:      int32 [N], the substep tier of each row's table.
      U:       output width of a row, a multiple of 512 up to 65536.
      fast_resolve: run the archive value-chase probes before the last far
               level (for ``xh_compress_resolved`` streams; right for any).
      hist:    uint8 [N, HU] or None: the bytes before each block,
               right-aligned (a row's last column is the byte just before
               the block); HU + U a multiple of 512 up to 131072.  The
               copies resolve over ``[hist | block]`` rows.
      hist_len: int32 [N] or None (0): how many bytes before the block an
               offset may reach; a longer one sets err.
      want_span: also return each row's byte span.

    Returns:
      out: uint8 [N, U] decoded bytes (tpucomp returns int32; the values
           are equal), zero past out_len
      err: bool [N] malformed-stream flag; the bytes of a row with err
           set are meaningless
      span: int32 [N], with ``want_span``: the body bytes the block takes
           (exact where err is clear)
    """
    parsed = parse_batch(payload, plen, out_len, ss, U, hist_len, want_span)
    out, err = _records_to_output(*parsed[:4], out_len, U, fast_resolve,
                                  hist)
    return (out, err, parsed[4]) if want_span else (out, err)


def parse_inputs(payload, plen, out_len, ss):
    """Each row's canonical tables: the arguments of :func:`xh_parse` but
    for U, (body, blen, out_len, ss, lim15, rbf, sym_by_rank)."""
    lengths = unpack_table(payload)
    _, fc, br, lim = canonical_from_lengths(lengths)
    lim15, rbf = level_tables(fc, br, lim)
    return (payload[:, TABLE:].contiguous(), plen - TABLE, out_len, ss,
            lim15, rbf, rank_to_symbol_table(lengths))


def parse_batch(payload, plen, out_len, ss, U: int, hist_len=None,
                want_span=False):
    """The head of :func:`decode_batch`: the tables, then the parse.
    Returns :func:`xh_parse`'s (rec_pos, rec_val, p_final, err[, span])."""
    return xh_parse(*parse_inputs(payload, plen, out_len, ss), U,
                    hist_len=hist_len, want_span=want_span)


def _records_to_output(rec_pos, rec_val, p_final, errk, out_len, U,
                       fast_resolve=False, hist=None):
    """Decode tail: token records -> output bytes (tpucomp's
    ``_records_to_output``, mode path; with ``hist``, its history path)."""
    # tpucomp's keep bound (8 * body / min code length + 8) never binds:
    # every record is one decoded symbol of at least that many bits.  Here
    # a row has at most U record slots, so keep = U cannot overflow either.
    vpack, tokpos, ovf = fill_records_delta2(rec_pos, rec_val, U, keep=U)
    err = (errk != 0) | (ovf != 0) | (p_final < out_len)
    planes = near_inputs(vpack, tokpos)
    HU = 0
    if hist is not None:
        HU = hist.shape[1]
        planes = history_planes(*planes, hist)
    out = far_rounds(resolve_near(*planes), HU + U, SEG,
                     fast=fast_resolve)[:, HU:]
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


def history_planes(is_copy, disp, litv, hist):
    """The near walk's planes of ``[hist | block]`` rows: the history's
    columns are literals (its bytes), so a copy that reaches before the
    block takes the history's byte, as over tpucomp's concatenated
    rows."""
    pad = torch.zeros(hist.shape, dtype=torch.int32, device=hist.device)
    return (torch.cat([pad.bool(), is_copy], 1), torch.cat([pad, disp], 1),
            torch.cat([hist.to(torch.int32), litv], 1))


@span("xh.pack_units", "stage")
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
    return tuple(to_device(a, device) for a in (
        payload, plen, np.asarray(out_lens, np.int32), ss))


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
    count("xh.units", len(streams))
    out, err = decode_batch(*batch, unit_size, fast_resolve=fast_resolve)
    count("xh.batch_decodes")
    if any_set(err, "sync.xh_err"):
        raise DataError("XpressHuff: malformed unit stream")
    out = to_host(out, "sync.xh_output")
    with span("xh.split_output", "stage"):
        units = [out[i, :o].tobytes() for i, o in enumerate(out_lens)]
        del out  # the host rows are freed in the stage
    return units


# --------------------------------------------------------------------------
# One-shot multi-block decode
# --------------------------------------------------------------------------


def _kraft_candidates(arr: np.ndarray, max_cands: int = MAX_CANDS):
    """Candidate block starts: the offsets whose next 256 bytes form a
    complete canonical table (the Kraft sum of the 512 four-bit lengths
    is 2^15), by one windowed cumsum over the stream.  Every block start
    of a conforming encoder qualifies but a single-symbol table's (the
    chain walk decodes that one on its own); body bytes seldom do.
    Returns None past ``max_cands`` candidates (the caller then walks the
    blocks one by one)."""
    n = len(arr)
    if n < TABLE:
        return np.empty(0, np.int64)
    lo = (arr & 0xF).astype(np.int64)
    hi = (arr >> 4).astype(np.int64)
    w = np.where(lo > 0, 1 << (15 - lo), 0) + np.where(
        hi > 0, 1 << (15 - hi), 0)
    c = np.concatenate([[0], np.cumsum(w)])
    offs = np.nonzero(c[TABLE:] - c[:-TABLE] == 1 << 15)[0]
    if len(offs) > max_cands:
        return None
    return offs


def batch_width(n: int, offs) -> int:
    """tpucomp's slice width of a speculative or fixpoint batch of the
    blocks at ``offs`` of an ``n``-byte stream: the longest slice's bytes
    in 16 KiB steps (at least 1024), 16 more, at most
    ``max_payload(65536)``."""
    MP = max_payload(BLOCK)
    longest = max(min(MP, n - o) for o in offs)
    return min(MP, max(1024, -(-longest // 16384) * 16384) + 16)


def walk_width(n: int, off: int) -> int:
    """tpucomp's slice width of the sequential walk's block at ``off``:
    its body's bytes left in 16 KiB steps (at least 1024), the table and
    16 more, at most ``max_payload(65536)``."""
    MP = max_payload(BLOCK)
    avail = min(MP, n - off)
    return min(MP, TABLE + max(1024, -(-(avail - TABLE) // 16384) * 16384)
               + 16)


@span("xh.pack_units", "stage")
def history_batch(data: bytes, offs, olens, hists, hlens, P: int, dev):
    """The batch of :func:`history_decode` on ``dev``: (payload, plen,
    out_len, ss, hist, hist_len), the arguments of :func:`decode_batch`
    at U = 65536 and its ``hist`` and ``hist_len``."""
    slices = [data[o:o + P] for o in offs]
    ss = max(_substeps_for(_min_code_len([s])) for s in slices)
    N = len(offs)
    payload = np.zeros((N, -(-P // 16) * 16), np.uint8)
    plen = np.zeros(N, np.int32)
    hist = np.zeros((N, HIST), np.uint8)
    for i, s in enumerate(slices):
        payload[i, :len(s)] = np.frombuffer(s, np.uint8)
        plen[i] = len(s)
        if hists[i]:
            h = np.frombuffer(hists[i], np.uint8)
            hist[i, HIST - len(h):] = h
    return [to_device(a, dev) for a in (
        payload, plen, np.asarray(olens, np.int32), np.full(N, ss, np.int32),
        hist, np.asarray(hlens, np.int32))]


def history_decode(data: bytes, offs, olens, hists, hlens, P: int, dev):
    """One batch decode: the blocks that start at ``offs`` in ``data``,
    each sliced to at most ``P`` bytes, decoding ``olens[i]`` bytes over
    the history ``hists[i]`` (bytes, right-aligned before the block; None
    for zeros) with reach ``hlens[i]``, all rows at the largest substep
    tier of the slices.  Counts itself (``xh.batch_decodes``) and its
    rows (``xh.units``).  Returns (outs uint8 [n, 65536], errs bool [n],
    spans int [n]) on the host."""
    batch = history_batch(data, offs, olens, hists, hlens, P, dev)
    count("xh.units", len(offs))
    out, err, spans = decode_batch(*batch[:4], BLOCK, hist=batch[4],
                                   hist_len=batch[5], want_span=True)
    count("xh.batch_decodes")
    err = to_host(err, "sync.xh_err")
    spans = to_host(spans, "sync.xh_span")
    return to_host(out, "sync.xh_output"), err, spans


def _malformed() -> DataError:
    return DataError("XpressHuff: malformed stream (or a match overrunning "
                     "a 64 KiB block boundary)")


def _decompress_speculative(data: bytes, out_len: int, dev):
    """The multi-block decode in a few batch decodes instead of one a
    block (tpucomp's ``_decompress_speculative``, step for step): the
    Kraft scan, one speculative batch of every candidate over an all-zero
    history, the chain walk by spans, then fixpoint passes with the real
    history until the output is stable (depth-k cross-block chains take
    k + 1 passes).  Returns the output, or None when the scan gives up
    or finds nothing (the caller walks the blocks instead)."""
    with span("xh.kraft_scan", "stage"):
        arr = np.frombuffer(data, np.uint8)
        cands = _kraft_candidates(arr)
    if cands is None:
        return None
    cands = cands[cands + TABLE <= len(arr)]
    if len(cands) == 0:
        return None

    def batch(offs, olens, hists, hlens):
        return history_decode(data, offs, olens, hists, hlens,
                              batch_width(len(data), offs), dev)

    # the speculative batch: every candidate, a full block, zero history
    offs = [int(o) for o in cands]
    outs, errs, spans = batch(offs, [BLOCK] * len(offs), [None] * len(offs),
                              [HIST] * len(offs))
    spec = {o: (outs[i].tobytes(), int(spans[i]))
            for i, o in enumerate(offs) if not errs[i]}
    del outs

    # the chain walk: the true block starts, by span
    with span("xh.chain_walk", "stage"):
        chain = []  # (offset, the block's decoded length)
        off, produced = 0, 0
        while produced < out_len:
            if off + TABLE > len(data):
                raise DataError("XpressHuff: stream ended before out_len "
                                "bytes")
            block_out = min(BLOCK, out_len - produced)
            if block_out != BLOCK or off not in spec:
                # no candidate (a single-symbol table, the partial last
                # block): one batch decode finds this link
                o2, e2, s2 = batch([off], [block_out], [None], [HIST])
                if e2[0]:
                    raise _malformed()
                spec[off] = (o2[0].tobytes(), int(s2[0]))
            chain.append((off, block_out))
            off += TABLE + spec[off][1]
            produced += block_out

    # the fixpoint: each block over the output of the one before it
    with span("xh.fixpoint", "stage"):
        cur = [spec[o][0][:bo] for o, bo in chain]
        offs = [o for o, _ in chain]
        olens = [bo for _, bo in chain]
        for _ in range(len(chain)):
            hists = [None] + [c[-HIST:] for c in cur[:-1]]
            hlens = [0] + [len(h) for h in hists[1:]]
            o3, e3, _ = batch(offs, olens, hists, hlens)
            if e3.any():
                raise _malformed()
            nxt = [o3[k, :olens[k]].tobytes() for k in range(len(chain))]
            stable = nxt == cur
            cur = nxt
            if stable:
                break
        return b"".join(cur)


def decompress(data: bytes, out_len=None, *, device="cuda") -> bytes:
    """One-shot decode of a (multi-block) XH stream to ``out_len`` bytes,
    tpucomp's ``decompress``: past 64 KiB the speculative path, else (or
    when it gives up) one batch decode a block, each with the last 64 KiB
    of output as its history.  Matches may reach back across blocks;
    one whose output runs past its block's 64 KiB raises
    :class:`DataError`, as any malformed stream does.  ``out_len`` is
    required (:class:`ArgError`).

    Its steps are the spans ``xh.kraft_scan``, ``xh.chain_walk``,
    ``xh.fixpoint`` or ``xh.sequential_walk``, and its batch decodes the
    counter ``xh.batch_decodes`` (:mod:`tpucomp_torch.stats`)."""
    data = bytes(data)
    if out_len is None:
        raise ArgError("XPRESS_HUFF decompression requires out_len")
    dev = resolve_device(device)
    if out_len == 0:
        return b""
    if out_len > BLOCK:
        got = _decompress_speculative(data, out_len, dev)
        if got is not None:
            return got
    with span("xh.sequential_walk", "stage"):
        parts = []
        off, produced = 0, 0
        tail = b""  # the last <= 64 KiB of output: the next block's history
        while produced < out_len:
            if off + TABLE > len(data):
                raise DataError("XpressHuff: stream ended before out_len "
                                "bytes")
            block_out = min(BLOCK, out_len - produced)
            out, err, spans = history_decode(data, [off], [block_out],
                                             [tail], [len(tail)],
                                             walk_width(len(data), off), dev)
            if err[0]:
                raise _malformed()
            block = out[0, :block_out].tobytes()
            parts.append(block)
            tail = (tail + block)[-HIST:]
            off += TABLE + int(spans[0])
            produced += block_out
        return b"".join(parts)


# --------------------------------------------------------------------------
# Encode
# --------------------------------------------------------------------------


def encode_batch(units: torch.Tensor, ulen: torch.Tensor,
                 match: MatchFinderConfig | None = None):
    """Encode a batch of units into single-block XH streams: the stages of
    the module docstring, tpucomp's ``_encode_impl``.

    Args (on one device):
      units: uint8 [N, n], unit bytes, zero-padded; n <= 65536 is the unit
             width (tpucomp takes int32; the values are equal).
      ulen:  int32 [N], true unit length.
      match: the match finder's parameters; :data:`config.DEFAULT` when
             None.

    Returns:
      payload: uint8 [N, max_payload(n)] stream bytes, 0 past plen
      plen:    int32 [N] stream length (260 for an empty unit: the table,
               two empty word slots)
    """
    # deferred: codecs.xpress imports this module
    from .xpress import find_matches

    with span("xh.find_matches", "compute"):
        best_len, best_disp, use_match, okpos = find_matches(
            units, ulen, match, max_disp=None)
    with span("xh.greedy_commit", "compute"):
        committed = greedy_commit(use_match, best_len, okpos)
    with span("xh.symbols", "compute"):
        sym = symbols(units, best_len, best_disp, use_match, committed)
    with span("xh.code_tables", "compute"):
        lengths, codes = code_tables(sym)
    with span("xh.lookup", "compute"):
        codelen = lookup(lengths, codes, sym)
    with span("xh.assemble_payload", "compute"):
        return assemble_payload(best_len, best_disp, use_match, committed,
                                lengths, codelen)


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of positive int32 ``x``, exactly (tpucomp's ``31 -
    clz(x)``), by halving the bit range five times."""
    out = torch.zeros_like(x)
    for sh in (16, 8, 4, 2, 1):
        big = (x >> sh) > 0
        out = torch.where(big, out + sh, out)
        x = torch.where(big, x >> sh, x)
    return out


def symbols(units, best_len, best_disp, use_match, committed):
    """int32 [N, n]: each committed token's symbol, a literal's byte or
    ``256 | obc << 4 | min(len - 3, 15)`` for a match (obc = floor(log2
    disp), the offset's raw bits), and 512 at every other position."""
    obc = floor_log2(best_disp.clamp(min=1))
    lh = (best_len - MIN_MATCH).clamp(max=15)
    sym = torch.where(committed & use_match, 256 | (obc << 4) | lh,
                      units.int())
    return torch.where(committed, sym, NUM_SYMBOLS)


def code_tables(sym: torch.Tensor):
    """Each row's code lengths and canonical codes, int32 [N, 512] each,
    from the histogram of its symbols."""
    return huffman_tables(histogram(sym, NUM_SYMBOLS))


def lookup(lengths, codes, sym):
    """``(code << 5) | length`` of each position's symbol, int32 [N, n],
    through the row gather (tpucomp's ``mxu_gather_rows`` at nbits 20);
    the sentinel 512 reads symbol 511's, which the layout masks."""
    return gather_rows((codes << 5) | lengths, sym.clamp(max=NUM_SYMBOLS - 1),
                       nbits=20)


def _rel_field(rel, b, v):
    """(lane, lo, hi): a field of b <= 15 bits at bit offset rel (0..30) of
    a two-word window lands in lane rel >> 4 (lo) and, when it straddles,
    the next lane (hi), MSB-first in each 16-bit lane."""
    fit = 16 - (rel & 15) - b
    lo = torch.where(fit >= 0, v << fit.clamp(min=0),
                     v >> (-fit).clamp(min=0)) & 0xFFFF
    lo = torch.where(b > 0, lo, 0)
    spill = (b > 0) & (fit < 0)
    hi = torch.where(spill, (v << (16 + fit).clamp(min=0)) & 0xFFFF, 0)
    return rel >> 4, lo, hi


def assemble_payload(best_len, best_disp, use_match, committed, lengths,
                     codelen):
    """The closed-form layout of tpucomp's lazy-flush writer
    (``_encode_impl`` from its layout on), from the walk and the lookup.

    The writer keeps at most 16 pending bits and flushes a 16-bit LE word
    once more are pending, so after B bits it has flushed (B - 1) >> 4
    words, and word w holds bits [16w, 16w + 16) MSB-first.  A token's
    code and offset fields (at most 30 bits) touch at most three words
    from its first, W = S_A >> 4.  Two word slots precede the data; an
    escape byte sits after the slots of the words flushed before its
    token, so the slot of word j >= 2 moves by the escape bytes of the
    tokens up to the one that flushed word j - 2 (the decoder reads two
    words ahead).  Returns (payload, plen).
    """
    N, n = best_len.shape
    dev = best_len.device
    i32 = torch.int32
    tok_copy = committed & use_match
    L = best_len - MIN_MATCH
    obc = floor_log2(best_disp.clamp(min=1))
    lh = L.clamp(max=15)
    offraw = best_disp & ((torch.ones_like(obc) << obc) - 1)
    rem = L - 15
    has_esc = tok_copy & (lh == 15)
    esc_big = has_esc & (rem >= 255)
    nraw = torch.where(has_esc, torch.where(esc_big, 3, 1), 0).to(i32)
    esc_b0 = torch.where(esc_big, 255, rem.clamp(min=0))
    # the u16 escape holds L itself (< 0x10000 for a unit of 64 KiB)
    esc_pack = esc_b0 | ((L & 0xFF) << 8) | (((L >> 8) & 0xFF) << 16)

    bits_a = torch.where(committed, codelen & 0x1F, 0)  # the code's length
    code_v = torch.where(committed, codelen >> 5, 0)
    bits_b = torch.where(tok_copy, obc, 0)  # the offset's raw bits
    offraw_v = torch.where(tok_copy, offraw, 0)
    bits_tok = bits_a + bits_b
    b_after = bits_tok.cumsum(1, dtype=i32)
    s_a = b_after - bits_tok
    ebytes = torch.where(tok_copy, nraw, 0)
    e_after = ebytes.cumsum(1, dtype=i32)
    e_p = e_after - ebytes
    b_tot = b_after[:, -1]
    raw_total = e_after[:, -1]
    flushes_after = ((b_after - 1) >> 4).clamp(min=0)
    F = ((b_tot - 1) >> 4).clamp(min=0)

    # word values, token-major: contributions c0, c1, c2 to words W, W + 1,
    # W + 2 of each token; the bits of different tokens are disjoint
    w_tok = s_a >> 4
    _, a_lo, a_hi = _rel_field(s_a & 15, bits_a, code_v)
    b_lane, b_lo, b_hi = _rel_field(s_a + bits_a - 16 * w_tok, bits_b,
                                    offraw_v)
    c0 = a_lo | torch.where(b_lane == 0, b_lo, 0)
    c1 = a_hi | torch.where(b_lane == 0, b_hi, b_lo)
    c2 = torch.where(b_lane == 1, b_hi, 0)
    WMAX = n + 8  # bits <= 15 L + 30 M with L + 3 M <= n
    wq = torch.arange(WMAX, dtype=i32, device=dev)[None, :]
    word_val = rolled_or([scatter_sorted_or(w_tok, c, WMAX)
                         for c in (c0, c1, c2)])
    nwords = F + (b_tot - 16 * F > 0).to(i32)
    # reserved but unwritten slots hold zeros, as the reference writer's
    wval = torch.where(wq < nwords[:, None], word_val, 0)

    # slot j >= 2 sits after the escape bytes of every token up to the last
    # one with flushes_after <= j - 2 (0 when there is none)
    ef = fill_records_delta(flushes_after, e_after, WMAX)
    e_shift = torch.cat([torch.zeros((N, 2), dtype=i32, device=dev),
                         ef[:, :WMAX - 2]], 1)
    wpos = torch.where(wq < 2, 2 * wq, 2 * wq + e_shift)
    slots_total = 2 + F
    r_start = 4 + 2 * flushes_after + e_p

    # byte assembly: word-slot bytes and escape bytes are two strictly
    # increasing position streams that partition the body
    body_len = 2 * slots_total + raw_total
    PB = 2 * n + 16
    wvalid = wq < slots_total[:, None]
    word_bytes = place_monotone(~wvalid, wpos, (wval & 0xFF, wval >> 8), PB)
    esc_vals = tuple(torch.where(nraw > k, (esc_pack >> (8 * k)) & 0xFF, 0)
                     for k in range(3))
    esc_bytes = place_monotone(nraw == 0, r_start, esc_vals, PB)
    body = rolled_or(word_bytes) | rolled_or(esc_bytes)
    bq = torch.arange(PB, dtype=i32, device=dev)[None, :]
    body = torch.where(bq < body_len[:, None], body, 0)
    table = lengths[:, 0::2] | (lengths[:, 1::2] << 4)
    payload = torch.cat([table, body], 1).to(torch.uint8)
    return payload, (TABLE + body_len).to(i32)


def compress_units(units, unit_size=BLOCK, *, device="cuda") -> list:
    """Compress independent units of at most ``unit_size`` <= 65536 bytes
    as single-block XH streams, all in one device batch, as tpucomp's
    ``compress_units`` (which slices the batch for its compiler and pads
    it with empty rows; neither changes a unit's bytes).  An empty unit
    gives a 260-byte stream, as in tpucomp."""
    dev = resolve_device(device)
    if not 0 < unit_size <= BLOCK:
        raise ArgError("XPRESS_HUFF units are single <= 64 KiB blocks, got "
                       f"unit_size {unit_size}")
    units = [bytes(u) for u in units]
    if not units:
        return []
    if any(len(u) > unit_size for u in units):
        raise ArgError("unit larger than unit_size")
    count("xh.units", len(units))
    return row_streams(*encode_batch(*unit_rows(units, unit_size, dev)))


def compress(data: bytes, *, device="cuda") -> bytes:
    """One-shot XH compress, tpucomp's ``compress``: 64 KiB blocks
    encoded in one batch and concatenated (the standard multi-block
    layout; matches stay inside their block)."""
    data = bytes(data)
    if not data:
        return b""
    units = [data[i:i + BLOCK] for i in range(0, len(data), BLOCK)]
    return b"".join(compress_units(units, device=device))

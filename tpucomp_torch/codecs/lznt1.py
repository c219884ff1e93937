"""LZNT1 encode and decode, chunk-parallel, on PyTorch tensors.

Counterpart of ``tpucomp/codecs/lznt1.py``.  One row of a batch is one
4 KiB chunk.  The decode pipeline:

  parse (kernel)  -> token records per payload byte step
  fill (kernel)   -> per output byte: its token's literal or displacement
  near resolve (kernel) -> copies inside each 512-byte segment resolved,
                     the rest tagged with their absolute source
  far level (kernel)    -> pointer doubling over the whole row
                     (``common.far_rounds`` at U = 4096: one level)

Stored-raw chunks bypass the pipeline: their payload is the output.

The encode pipeline (:func:`encode_batch`), whose payloads equal
tpucomp's byte for byte at the same ``MatchFinderConfig``:

  run matcher (kernel) -> exact run lengths at displacements 1, 2, 3
  hash match finder    -> row sort (kernel) of the chain keys, capped
                          word compares, un-sort (the same kernel)
  extend_saturated     -> exact lengths of the cap-saturated matches
  lazy step, greedy commit walk with layout sums (kernel)
  byte assembly        -> direct scatters of tokens and flag bytes
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import DEFAULT, MatchFinderConfig
from ..errors import ArgError, DataError
from ..kernels.commit import greedy_commit_layout
from ..kernels.common import far_rounds, place_monotone, scatter_sorted_or
from ..kernels.fill import fill_records_delta
from ..kernels.lznt1_parse import COPY_BIT, lznt1_parse
from ..kernels.match import extend_saturated, hash_best_match
from ..kernels.resolve import SEG, resolve_near
from ..kernels.runs import run_matchlens
from ..stats import count, span
from ..util import any_set, resolve_device, to_device, to_host

CHUNK = 4096
# Compressed payload bound: 4096 literals + 512 flag bytes.
MAX_PAYLOAD = CHUNK + CHUNK // 8
# Input payload pad (also covers raw chunks).
PAYLOAD_PAD = MAX_PAYLOAD + 8


def batch_from_numpy(payload: np.ndarray, plen: np.ndarray,
                     is_comp: np.ndarray, device="cuda"):
    """Move the numpy batch that ``tpucomp.codecs.lznt1.decode_batch``
    takes (int32 [N, PAYLOAD_PAD], int32 [N], bool [N]) onto ``device``.

    The payload lands as uint8 (its values are bytes); plen as int32 and
    is_comp as bool.
    """
    dev = resolve_device(device)
    payload = np.asarray(payload)
    plen = np.asarray(plen, np.int32)
    is_comp = np.asarray(is_comp, bool)
    N = payload.shape[0]
    if payload.shape != (N, PAYLOAD_PAD) or plen.shape != (N,) \
            or is_comp.shape != (N,):
        raise ArgError(f"expected [N, {PAYLOAD_PAD}], [N] and [N] arrays")
    if N and (plen.min() < 0 or plen.max() > PAYLOAD_PAD):
        raise ArgError(f"plen must lie in [0, {PAYLOAD_PAD}]")
    return (torch.from_numpy(payload.astype(np.uint8)).to(dev),
            torch.from_numpy(plen).to(dev),
            torch.from_numpy(is_comp).to(dev))


@span("lznt1.decode", "compute")
def decode_batch(payload: torch.Tensor, plen: torch.Tensor,
                 is_comp: torch.Tensor):
    """Decode a batch of LZNT1 chunk payloads (headers already stripped).

    Args (all on one device, e.g. from :func:`batch_from_numpy`):
      payload: uint8 [N, PAYLOAD_PAD], per-chunk payload bytes, zero-padded.
      plen:    int32 [N], true payload byte length.
      is_comp: bool [N], compressed flag from each chunk header.

    Returns:
      out:     uint8 [N, CHUNK] decoded bytes (tpucomp returns int32; the
               values are equal), zero past out_len
      out_len: int32 [N] decoded length per chunk
      err:     bool [N] malformed-stream flag; the bytes of a row with
               err set are meaningless
    """
    rec_pos, rec_val, p_final, errk = lznt1_parse(payload, plen, is_comp)
    return _records_to_output(rec_pos, rec_val, p_final, errk != 0,
                              payload, plen, is_comp)


def _records_to_output(rec_pos, rec_val, p_final, err, payload, plen,
                       is_comp):
    """Decode tail: token records -> output bytes."""
    vpack = fill_records_delta(rec_pos, rec_val, CHUNK)
    is_copy = (vpack & COPY_BIT) != 0
    disp = vpack & (COPY_BIT - 1)
    litv = torch.where(is_copy, 0, vpack & 0xFF)
    out_comp = far_rounds(resolve_near(is_copy, disp, litv), CHUNK, SEG)
    out = torch.where(is_comp[:, None], out_comp.to(torch.uint8),
                      payload[:, :CHUNK])
    out_len = torch.where(is_comp, p_final, plen.clamp(max=CHUNK))
    j = torch.arange(CHUNK, device=out.device)
    out = torch.where(j < out_len[:, None], out, 0)
    return out, out_len, err


def split_stream(data: bytes):
    """Sequential header scan of an LZNT1 stream -> per-chunk payloads
    and compressed flags.  A 0x0000 header (or the end) ends the stream."""
    payloads, comps = [], []
    i, nb = 0, len(data)
    while i + 2 <= nb:
        header = data[i] | (data[i + 1] << 8)
        i += 2
        if header == 0:
            break
        size = (header & 0xFFF) + 1
        if i + size > nb:
            raise DataError("LZNT1: chunk payload extends past end of input")
        payloads.append(data[i: i + size])
        comps.append(bool(header & 0x8000))
        i += size
    return payloads, comps


@span("lznt1.pack_chunks", "stage")
def pack_chunks(payloads, comps, device):
    """Chunk payloads -> a batch on ``device``, one row per chunk.

    tpucomp pads the rows up to ``batch_multiple * 2^k`` to bound XLA
    recompiles; eager PyTorch has nothing to recompile, so no row here is
    padding."""
    N = len(payloads)
    payload = np.zeros((N, PAYLOAD_PAD), np.uint8)
    plen = np.zeros(N, np.int32)
    is_comp = np.zeros(N, bool)
    for k, (pl, cp) in enumerate(zip(payloads, comps)):
        payload[k, :len(pl)] = np.frombuffer(pl, np.uint8)
        plen[k] = len(pl)
        is_comp[k] = cp
    count("lznt1.chunks", N)
    count("lznt1.chunks_compressed", int(np.count_nonzero(is_comp)))
    return (to_device(payload, device), to_device(plen, device),
            to_device(is_comp, device))


@span("lznt1.joined_output", "stage")
def joined_output(out: torch.Tensor, out_len: torch.Tensor) -> bytes:
    """The first out_len[k] bytes of every row k, concatenated."""
    keep = torch.arange(CHUNK, device=out.device) < out_len[:, None]
    # the mask's selection waits on the card for its size
    with span("sync.lznt1_output", "sync"):
        kept = out[keep]
        count("d2h_bytes", kept.nbytes)
        kept = kept.cpu()
    return kept.numpy().tobytes()


def decompress(data: bytes, out_len=None, *, device="cuda") -> bytes:
    """One-shot LZNT1 decode on ``device`` (chunk-parallel)."""
    dev = resolve_device(device)
    data = bytes(data)
    with span("lznt1.split_stream", "stage"):
        payloads, comps = split_stream(data)
    if not payloads:
        return b""
    out, out_lens, err = decode_batch(*pack_chunks(payloads, comps, dev))
    if any_set(err, "sync.lznt1_err"):
        raise DataError("LZNT1: malformed stream")
    result = joined_output(out, out_lens)
    if out_len is not None:
        if len(result) < out_len:
            raise DataError("LZNT1: stream ended before out_len bytes")
        with span("lznt1.joined_output", "stage"):
            result = result[:out_len]
    return result


def decompress_chunks(chunks, *, device="cuda"):
    """Decode complete chunks, each its 2-byte header and payload, in one
    batch: the streaming decoder's feed.

    Returns the chunks' output joined and None, or ``b""`` and the index
    of the first malformed chunk (the streaming decoder consumes the
    chunks up to it and raises there, as tpucomp's, which decodes a chunk
    a call)."""
    dev = resolve_device(device)
    if not chunks:
        return b"", None
    payloads = [c[2:] for c in chunks]
    comps = [bool(c[1] & 0x80) for c in chunks]
    out, out_lens, err = decode_batch(*pack_chunks(payloads, comps, dev))
    with span("sync.lznt1_err", "sync"):
        bad = err.nonzero().cpu()
    if len(bad):
        return b"", int(bad[0, 0])
    return joined_output(out, out_lens), None


def decompress_units(streams, *, device="cuda") -> list:
    """Decode independent LZNT1 unit streams in one batch.

    Each unit may hold several chunks: every unit is split into its chunks
    on the host, all chunks decode in one batch, and the output is
    reassembled per unit (as ``tpucomp.dist.ShardedCodec`` does).
    """
    dev = resolve_device(device)
    payloads, comps, owner = [], [], []
    with span("lznt1.split_stream", "stage"):
        for i, s in enumerate(streams):
            try:
                pls, cps = split_stream(bytes(s))
            except DataError as e:
                raise ArgError("LZNT1: truncated chunk in unit") from e
            payloads += pls
            comps += cps
            owner += [i] * len(pls)
    if not payloads:
        return [b"" for _ in streams]
    out, out_lens, err = decode_batch(*pack_chunks(payloads, comps, dev))
    if any_set(err, "sync.lznt1_err"):
        raise ArgError("LZNT1: malformed unit")
    flat = joined_output(out, out_lens)
    ends = np.cumsum(to_host(out_lens, "sync.lznt1_out_lens"))
    with span("lznt1.joined_output", "stage"):
        parts = [[] for _ in streams]
        for k, i in enumerate(owner):
            parts[i].append(flat[ends[k - 1] if k else 0: ends[k]])
        return [b"".join(p) for p in parts]


# --------------------------------------------------------------------------
# Encode
# --------------------------------------------------------------------------

MIN_MATCH = 3


def _split_tables():
    """Per output position p: the largest ``length - 3`` a copy token can
    hold there, and its displacement shift (``12 - max(bitlen(p - 1) - 4,
    0)``), tpucomp's ``L_MASK_TABLE`` and ``D_SHIFT_TABLE``."""
    q = np.maximum(np.arange(CHUNK) - 1, 0)
    bitlen = np.zeros(CHUNK, np.int32)
    for b in range(13):
        bitlen[q >= (1 << b)] = b + 1
    shifts = np.maximum(bitlen - 4, 0)
    return (((1 << (12 - shifts)) - 1).astype(np.int32),
            (12 - shifts).astype(np.int32))


L_MASK_TABLE, D_SHIFT_TABLE = _split_tables()


@functools.lru_cache(maxsize=None)
def _split_tables_on(dev: torch.device):
    """The two tables as [1, CHUNK] int32 tensors on ``dev``, copied once."""
    return tuple(to_device(t, dev)[None, :]
                 for t in (L_MASK_TABLE, D_SHIFT_TABLE))


def encode_batch(chunks: torch.Tensor, clen: torch.Tensor,
                 match: MatchFinderConfig | None = None):
    """Encode a batch of chunks of at most 4096 bytes into LZNT1 token
    payloads (headers not included): :func:`find_matches`, the greedy
    walk (:func:`~tpucomp_torch.kernels.commit.greedy_commit_layout`),
    then :func:`assemble_payload`.

    Args (on one device):
      chunks: uint8 [N, CHUNK], chunk bytes, zero-padded (tpucomp takes
              int32; the values are equal).
      clen:   int32 [N], true chunk length.
      match:  the match finder's parameters; :data:`config.DEFAULT` when
              None.

    Returns:
      payload: uint8 [N, MAX_PAYLOAD] token and flag bytes, 0 past plen
      plen:    int32 [N] payload length, 0 for an empty chunk (the caller
               stores a chunk raw when ``plen >= clen``)
    """
    with span("lznt1.find_matches", "compute"):
        best_len, best_disp, use_match, okpos = find_matches(chunks, clen,
                                                             match)
    with span("lznt1.greedy_commit", "compute"):
        walk = greedy_commit_layout(use_match, best_len, okpos)
    with span("lznt1.assemble_payload", "compute"):
        return assemble_payload(chunks, best_len, best_disp, use_match,
                                *walk)


def find_matches(chunks: torch.Tensor, clen: torch.Tensor,
                 match: MatchFinderConfig | None = None):
    """Match finding and the lazy step of :func:`encode_batch`.

    Returns ``best_len`` and ``best_disp`` (int32 [N, CHUNK], the lengths
    clipped to the format's and the chunk's limits), ``use_match`` (bool:
    a match the walk takes where it stands) and ``okpos`` (bool: inside
    the chunk), the walk's inputs.
    """
    match = DEFAULT if match is None else match
    N, n = chunks.shape
    if chunks.dtype != torch.uint8 or n != CHUNK:
        raise ValueError(f"chunks must be a uint8 [N, {CHUNK}] tensor")
    if clen.dtype != torch.int32 or tuple(clen.shape) != (N,):
        raise ValueError("clen must be an int32 [N] tensor")
    dev = chunks.device
    pos = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    in_len = clen[:, None]
    l_mask, _ = _split_tables_on(dev)

    # candidate scoring: runs for each d, then the hash match; a later
    # candidate wins only with a strictly longer length
    best_len = torch.zeros((N, n), dtype=torch.int32, device=dev)
    best_disp = torch.ones((N, n), dtype=torch.int32, device=dev)

    def consider(length, disp, cond):
        nonlocal best_len, best_disp
        better = cond & (length > best_len)
        best_len = torch.where(better, length, best_len)
        best_disp = torch.where(better, disp, best_disp)

    run_disps = tuple(match.run_disps)
    for d, ml in zip(run_disps, run_matchlens(chunks, run_disps)):
        consider(ml, d, ml >= MIN_MATCH)
    hl, hd = hash_best_match(chunks, n, pos_bits=12,
                             hash_bits=match.hash_bits,
                             num_cands=match.num_candidates, cap=match.cap)
    hl = extend_saturated(hl, hd, match.cap, n)
    consider(hl, hd, hl >= MIN_MATCH)

    # clip to the format's and the chunk's limits
    best_len = torch.minimum(best_len,
                             torch.minimum(l_mask + MIN_MATCH, in_len - pos))
    is_match = (best_len >= MIN_MATCH) & (pos + MIN_MATCH <= in_len)
    # lazy step: defer a match when the next position has a strictly
    # longer one
    next_bl = torch.zeros_like(best_len)
    next_bl[:, :-1] = best_len[:, 1:]
    use_match = is_match & ~(next_bl > best_len)
    okpos = (pos < in_len).expand(N, n).contiguous()
    return best_len, best_disp, use_match, okpos


def assemble_payload(chunks, best_len, best_disp, use_match, committed,
                     t_after, data_before):
    """The byte assembly of :func:`encode_batch`, from the walk's output.

    Committed position p is token t = t_after[p] - 1 of group t >> 3; its
    first byte sits at (t >> 3) + 1 + data_before[p] (one flag byte per
    started group precedes the group's data).  Every payload byte is
    written once, so each plane is one scatter.  Returns (payload, plen).
    """
    N, n = chunks.shape
    dev = chunks.device
    _, d_shift = _split_tables_on(dev)
    T_total = t_after[:, -1]
    last_c = committed[:, -1].int()
    data_total = (data_before[:, -1] + last_c
                  + last_c * use_match[:, -1].int())
    t_idx = t_after - 1
    grp_p = t_idx >> 3
    off_p = grp_p + 1 + data_before
    iscp_p = committed & use_match
    tokv = ((best_disp - 1) << d_shift) | (best_len - MIN_MATCH)
    b0 = torch.where(iscp_p, tokv & 0xFF, chunks.int())
    NG = n // 8
    fval = scatter_sorted_or(
        grp_p, torch.where(iscp_p, 1 << (t_idx & 7), 0), NG)
    # each group's flag byte goes just before its first token (+1 so that
    # a real offset 0 survives; 0 means "no such group")
    fpos1 = place_monotone(~(committed & ((t_idx & 7) == 0)), grp_p, off_p,
                           NG)
    ngroups = (T_total + 7) >> 3
    grp_exists = torch.arange(NG, device=dev)[None, :] < ngroups[:, None]
    d_b0, d_hi = place_monotone(
        ~committed, off_p,
        (torch.where(committed, b0, 0), torch.where(iscp_p, tokv >> 8, 0)),
        MAX_PAYLOAD)
    d_fl = place_monotone(~grp_exists, fpos1 - 1,
                          torch.where(grp_exists, fval, 0), MAX_PAYLOAD)
    # a copy's high byte follows its low byte (the last column wraps to
    # the first, as tpucomp's roll does)
    val = d_b0 | d_hi.roll(1, 1) | d_fl
    plen = torch.where(T_total > 0, ngroups + data_total, 0).to(torch.int32)
    bq = torch.arange(MAX_PAYLOAD, device=dev)[None, :]
    payload = torch.where(bq < plen[:, None], val, 0).to(torch.uint8)
    return payload, plen


def split_chunks(data: bytes):
    """The 4 KiB chunks of ``data`` as numpy uint8 [N, CHUNK] rows
    (zero-padded) and their int32 [N] lengths."""
    arr = np.frombuffer(data, np.uint8)
    N = -(-len(arr) // CHUNK)
    chunks = np.zeros((N, CHUNK), np.uint8)
    chunks.reshape(-1)[:len(arr)] = arr
    clen = np.minimum(len(arr) - np.arange(N) * CHUNK, CHUNK).astype(np.int32)
    return chunks, clen


def frame_chunks(payload: np.ndarray, plen: np.ndarray, chunks: np.ndarray,
                 clen: np.ndarray) -> list:
    """Each chunk's header and body, as tpucomp writes them: compressed
    (``0xB000 | plen - 1``, then the payload) when ``plen < clen``, else
    stored raw (``0x3000 | clen - 1``, then the chunk)."""
    out = []
    raw = 0
    for k in range(len(clen)):
        pl, cl = int(plen[k]), int(clen[k])
        if pl < cl:
            out.append((0xB000 | (pl - 1)).to_bytes(2, "little")
                       + payload[k, :pl].tobytes())
        else:
            raw += 1
            out.append((0x3000 | (cl - 1)).to_bytes(2, "little")
                       + chunks[k, :cl].tobytes())
    count("lznt1.chunks_raw", raw)
    return out


def _encode_rows(chunks: np.ndarray, clen: np.ndarray, dev):
    """The chunks' payloads and their lengths, encoded on ``dev``, on the
    host."""
    payload, plen = encode_batch(to_device(chunks, dev),
                                 to_device(clen, dev))
    return (to_host(payload, "sync.lznt1_payload"),
            to_host(plen, "sync.lznt1_plen"))


def _encode_framed(chunks: np.ndarray, clen: np.ndarray, dev) -> list:
    encoded = _encode_rows(chunks, clen, dev)
    with span("lznt1.frame_chunks", "stage"):
        return frame_chunks(*encoded, chunks, clen)


def compress(data: bytes, *, device="cuda") -> bytes:
    """One-shot LZNT1 encode on ``device`` (chunk-parallel, stored-raw
    fallback), equal to tpucomp's ``compress`` at its default config."""
    dev = resolve_device(device)
    data = bytes(data)
    if not data:
        return b""
    with span("lznt1.split_chunks", "stage"):
        chunks, clen = split_chunks(data)
        count("lznt1.chunks", len(clen))
    encoded = _encode_rows(chunks, clen, dev)
    with span("lznt1.frame_chunks", "stage"):
        framed = b"".join(frame_chunks(*encoded, chunks, clen))
        del chunks, encoded  # the host rows are freed in the stage
    return framed


def compress_units(units, *, device="cuda") -> list:
    """Encode independent units of at most 4096 bytes in one batch, one
    chunk (and one stream) per unit, as tpucomp's ``compress_batch``.

    An empty unit gives ``b""`` (tpucomp raises ``OverflowError`` on its
    header); a unit longer than 4096 bytes raises :class:`ArgError`.
    """
    dev = resolve_device(device)
    units = [bytes(u) for u in units]
    for i, u in enumerate(units):
        if len(u) > CHUNK:
            raise ArgError(f"LZNT1: unit {i} has {len(u)} bytes; a unit is "
                           f"one chunk of at most {CHUNK}")
    full = [i for i, u in enumerate(units) if u]
    out = [b""] * len(units)
    if not full:
        return out
    with span("lznt1.split_chunks", "stage"):
        chunks = np.zeros((len(full), CHUNK), np.uint8)
        clen = np.zeros(len(full), np.int32)
        for k, i in enumerate(full):
            chunks[k, :len(units[i])] = np.frombuffer(units[i], np.uint8)
            clen[k] = len(units[i])
        count("lznt1.chunks", len(full))
    for i, framed in zip(full, _encode_framed(chunks, clen, dev)):
        out[i] = framed
    return out


def max_compressed_size(n: int) -> int:
    """Worst-case LZNT1 stream size for ``n`` input bytes: every chunk
    stored raw behind its 2-byte header, plus a 2-byte terminator."""
    nchunks = (n + CHUNK - 1) // CHUNK
    return n + 2 * max(nchunks, 1) + 2

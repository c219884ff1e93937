"""Plain Xpress unit encode and decode, unit-parallel, on PyTorch tensors.

Counterpart of ``tpucomp/codecs/xpress.py`` ([MS-XCA] §2.3-2.4) for
independent units of at most 64 KiB, one row each: each unit is a
complete stream whose matches stay inside it.  The decode pipeline (the
mode path of tpucomp's ``_decode_impl``):

  parse (kernel)        -> token records per payload byte step
  fill (kernel)         -> per output byte: its token's literal or offset,
                           and the token's start
  periodic fold         -> a byte past the first period of an overlapping
                           match copies from that period
  near resolve (kernel) -> copies inside each 512-byte segment resolved
  far rounds (kernels)  -> the 4 KiB segment level, then the full row

tpucomp buckets units by stream size (XLA shapes); here every unit
decodes in one batch padded to the longest stream: the parse stops at
each row's length, so the padding changes nothing.

The encode pipeline (:func:`encode_batch`), whose streams equal tpucomp's
``_encode_impl`` byte for byte at the same ``MatchFinderConfig``:

  run matcher (kernel) -> exact run lengths at displacements 1, 2, 3
  hash match finder    -> row sort (kernel) of the chain keys, capped word
                          compares within the 8 KiB window, un-sort
  extend_saturated     -> exact lengths of the cap-saturated matches
  (second pass)        -> the same at a 5-byte hash seed, when configured
  lazy step, greedy commit walk (kernel)
  byte assembly        -> token, escape, shared-nibble and flag-word bytes
                          by direct scatters

The one-shot calls take buffers of at most 64 KiB, as one unit of 4, 16
or 64 KiB, as tpucomp's device backend does.  tpucomp's single-stream
encoder for larger buffers (``compress_stream``) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT, MatchFinderConfig
from ..errors import ArgError, DataError, UnsupportedFormatError
from ..kernels.commit import greedy_commit
from ..kernels.common import (
    far_rounds,
    place_monotone,
    rolled_or,
    scatter_sorted_or,
)
from ..kernels.fill import fill_records_delta2
from ..kernels.match import extend_saturated, hash_best_match
from ..kernels.resolve import SEG, resolve_near
from ..kernels.runs import run_matchlens
from ..kernels.xp_parse import xp_parse
from ..util import resolve_device, row_streams, unit_rows
from .xpress_huff import near_inputs

MIN_MATCH = 3
WINDOW = 8192  # [MS-XCA] match offsets reach at most 8 KiB back
UNIT = 65536  # the default unit of the batch calls, and the widest
_ONESHOT_UNITS = (4096, 16384, 65536)


def max_payload(u: int) -> int:
    """Worst-case unit stream: all literals, a flag word per 32, slack."""
    return u + 4 * ((u + 31) // 32) + 8


def max_compressed_size(n: int) -> int:
    """Worst-case stream size for ``n`` input bytes, as tpucomp's."""
    return n + 4 * ((n + 31) // 32) + 4


def _check_unit_size(unit_size: int) -> None:
    if not 0 < unit_size <= UNIT:
        raise ArgError(f"xpress unit_size must lie in (0, {UNIT}], got "
                       f"{unit_size}")


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------


def batch_from_numpy(payload: np.ndarray, plen: np.ndarray,
                     out_len: np.ndarray, device="cuda"):
    """Move the numpy batch that tpucomp's decoder takes (payload int32
    [N, P], plen and out_len int32 [N]) onto ``device``.  The payload
    lands as uint8 (its values are bytes)."""
    dev = resolve_device(device)
    payload = np.asarray(payload)
    N = payload.shape[0]
    plen, out_len = (np.asarray(a, np.int32) for a in (plen, out_len))
    if payload.ndim != 2 or plen.shape != (N,) or out_len.shape != (N,):
        raise ArgError("expected [N, P], [N] and [N] arrays")
    if N and (plen.min() < 0 or plen.max() > payload.shape[1]):
        raise ArgError(f"plen must lie in [0, {payload.shape[1]}]")
    return (torch.from_numpy(payload.astype(np.uint8)).to(dev),
            torch.from_numpy(plen).to(dev), torch.from_numpy(out_len).to(dev))


def decode_batch(payload: torch.Tensor, plen: torch.Tensor,
                 out_len: torch.Tensor, U: int):
    """Decode a batch of plain Xpress unit streams.

    Args (all on one device, e.g. from :func:`batch_from_numpy`):
      payload: uint8 [N, P], each stream, zero-padded.
      plen:    int32 [N], stream length in bytes.
      out_len: int32 [N], decoded length, <= U.
      U:       the unit width, up to 65536.  The tail runs at the next
               multiple of 512: output bytes past out_len do not change
               the ones before, and the parse's records and err depend on
               out_len, not on U.

    Returns:
      out: uint8 [N, U] decoded bytes (tpucomp returns int32; the values
           are equal), zero past out_len
      err: bool [N] malformed-stream flag; the bytes of a row with err
           set are meaningless
    """
    return _records_to_output(*xp_parse(payload, plen, out_len, U), out_len,
                              U)


def _records_to_output(rec_pos, rec_val, p_final, errk, out_len, U):
    """Decode tail: token records -> output bytes (tpucomp's
    ``_records_to_output``, mode path)."""
    W = -(-U // SEG) * SEG
    # the fill's overflow flag is not part of err, as in tpucomp: a row's
    # positions strictly increase up to out_len <= U, so it cannot overflow
    vpack, tokpos, _ = fill_records_delta2(rec_pos, rec_val, W)
    err = (errk != 0) | (p_final < out_len)
    out = far_rounds(resolve_near(*near_inputs(vpack, tokpos)), W, SEG)
    j = torch.arange(U, dtype=torch.int32, device=out.device)
    out = torch.where(j < out_len[:, None], out[:, :U], 0).to(torch.uint8)
    return out, err


def pack_units(streams, out_lens, unit_size: int, device):
    """Unit streams -> a batch on ``device``, one row per unit, padded to
    the longest stream.  Raises :class:`ArgError` for an out_len past
    ``unit_size`` and :class:`DataError` for a stream longer than any
    unit of ``unit_size`` bytes encodes to (tpucomp fails there with
    numpy's broadcast ``ValueError``)."""
    if any(o > unit_size for o in out_lens):
        raise ArgError("out_len larger than unit_size")
    if any(o < 0 for o in out_lens):
        raise ArgError("out_len must be non-negative")
    cap = max_payload(unit_size)
    if any(len(s) > cap for s in streams):
        raise DataError("Xpress: unit stream longer than a unit's largest "
                        "encoding")
    N = len(streams)
    P = -(-max(1, max(len(s) for s in streams)) // 16) * 16
    payload = np.zeros((N, P), np.uint8)
    plen = np.zeros(N, np.int32)
    for i, s in enumerate(streams):
        payload[i, :len(s)] = np.frombuffer(s, np.uint8)
        plen[i] = len(s)
    return (torch.from_numpy(payload).to(device),
            torch.from_numpy(plen).to(device),
            torch.from_numpy(np.asarray(out_lens, np.int32)).to(device))


def decompress_units(streams, out_lens, unit_size=UNIT, fast_resolve=False,
                     *, device="cuda") -> list:
    """Decompress a batch of independent Xpress unit streams, all in one
    device batch.

    ``out_lens[i]`` is unit i's decoded length, at most ``unit_size``
    (:class:`ArgError` otherwise).  A malformed unit raises
    :class:`DataError`.  ``fast_resolve`` is accepted for parity with
    tpucomp, which never probes on this path, and changes nothing.
    """
    del fast_resolve
    if not streams:
        return []
    dev = resolve_device(device)
    _check_unit_size(unit_size)
    streams = [bytes(s) for s in streams]
    out_lens = [int(o) for o in out_lens]
    if len(out_lens) != len(streams):
        raise ArgError("one out_len per stream is required")
    out, err = decode_batch(*pack_units(streams, out_lens, unit_size, dev),
                            unit_size)
    if bool(err.any()):
        raise DataError("Xpress: malformed unit stream")
    out = out.cpu().numpy()
    return [out[i, :o].tobytes() for i, o in enumerate(out_lens)]


def _oneshot_unit(n: int) -> int:
    for u in _ONESHOT_UNITS:
        if n <= u:
            return u
    raise UnsupportedFormatError(
        "XPRESS one-shot device calls cover buffers <= 64 KiB (a plain "
        "Xpress stream is a single sequential flag/nibble stream); use "
        "tpucomp's cpu or oracle backend for larger one-shot buffers, or "
        "decompress_batch / compress_batch for unit-batched segments")


def decompress(data: bytes, out_len=None, *, device="cuda") -> bytes:
    """One-shot plain Xpress decode of a stream of at most 64 KiB output,
    as one unit of 4, 16 or 64 KiB (tpucomp's device backend)."""
    if out_len is None:
        raise ArgError("Xpress decompression requires out_len")
    if out_len == 0:
        return b""
    return decompress_units([bytes(data)], [out_len],
                            unit_size=_oneshot_unit(out_len),
                            device=device)[0]


# --------------------------------------------------------------------------
# Encode
# --------------------------------------------------------------------------


def encode_batch(units: torch.Tensor, ulen: torch.Tensor,
                 match: MatchFinderConfig | None = None):
    """Encode a batch of units into plain Xpress streams:
    :func:`find_matches`, the greedy walk
    (:func:`~tpucomp_torch.kernels.commit.greedy_commit`), then
    :func:`assemble_payload`.

    Args (on one device):
      units: uint8 [N, n], unit bytes, zero-padded; n <= 65536 is the unit
             width (tpucomp takes int32; the values are equal).
      ulen:  int32 [N], true unit length.
      match: the match finder's parameters; :data:`config.DEFAULT` when
             None.

    Returns:
      payload: uint8 [N, max_payload(n)] stream bytes, 0 past plen
      plen:    int32 [N] stream length, 0 for an empty unit
    """
    best_len, best_disp, use_match, okpos = find_matches(units, ulen, match)
    committed = greedy_commit(use_match, best_len, okpos)
    return assemble_payload(units, best_len, best_disp, use_match, committed)


def find_matches(units: torch.Tensor, ulen: torch.Tensor,
                 match: MatchFinderConfig | None = None,
                 max_disp: int | None = WINDOW):
    """Match finding and the lazy step of :func:`encode_batch`
    (tpucomp's ``_encode_impl`` up to its walk).  ``max_disp`` bounds the
    hash matches' displacement: Xpress's 8 KiB window, or None for Xpress
    Huffman, whose window is the whole block.

    Returns ``best_len`` and ``best_disp`` (int32 [N, n], the lengths
    clipped to the unit), ``use_match`` (bool: a match the walk takes
    where it stands) and ``okpos`` (bool: inside the unit), the walk's
    inputs.
    """
    match = DEFAULT if match is None else match
    N, n = units.shape
    if units.dtype != torch.uint8 or units.dim() != 2 or not 0 < n <= UNIT:
        raise ValueError(f"units must be a uint8 [N, n <= {UNIT}] tensor")
    if ulen.dtype != torch.int32 or tuple(ulen.shape) != (N,):
        raise ValueError("ulen must be an int32 [N] tensor")
    dev = units.device
    pos = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    in_len = ulen[:, None]

    # candidates: runs for each d, then the hash match(es); a later
    # candidate wins only with a strictly longer length
    best_len = torch.zeros((N, n), dtype=torch.int32, device=dev)
    best_disp = torch.ones((N, n), dtype=torch.int32, device=dev)

    def consider(length, disp, cond):
        nonlocal best_len, best_disp
        better = cond & (length > best_len)
        best_len = torch.where(better, length, best_len)
        best_disp = torch.where(better, disp, best_disp)

    run_disps = tuple(match.run_disps)
    for d, ml in zip(run_disps, run_matchlens(units, run_disps)):
        consider(ml, d, ml >= MIN_MATCH)
    passes = [(match.num_candidates, 3)]
    if match.second_hash_cands:
        passes.append((match.second_hash_cands, 5))
    for num_cands, seed in passes:
        hl, hd = hash_best_match(units, n, hash_bits=match.hash_bits,
                                 num_cands=num_cands, cap=match.cap,
                                 max_disp=max_disp, seed=seed)
        # exact lengths past the compare cap (the reference is uncapped)
        hl = extend_saturated(hl, hd, match.cap, n)
        consider(hl, hd, hl >= MIN_MATCH)

    best_len = torch.minimum(best_len, in_len - pos)
    is_match = (best_len >= MIN_MATCH) & (pos + MIN_MATCH <= in_len)
    # lazy step: defer a match when the next position has a strictly
    # longer one
    next_bl = torch.zeros_like(best_len)
    next_bl[:, :-1] = best_len[:, 1:]
    use_match = is_match & ~(next_bl > best_len)
    okpos = (pos < in_len).expand(N, n).contiguous()
    return best_len, best_disp, use_match, okpos


def _match_extra_sizes(L, opens):
    """Bytes of a match beyond its 2-byte token, for L = length - 3 and
    whether it opens a fresh nibble byte; also (rem, big): the length past
    the token's 7 and whether it takes the u16 (and maybe u32) escape."""
    nib_user = L >= 7
    rem = (L - 7).clamp(min=0)
    big = nib_user & (rem >= 15) & (rem - 15 >= 255)
    sz = ((nib_user & opens).int() + (nib_user & (rem >= 15)).int()
          + 2 * big.int() + 4 * (big & (L >= 0x10000)).int())
    return sz, rem, big


def assemble_payload(units, best_len, best_disp, use_match, committed):
    """The byte assembly of :func:`encode_batch`, from the walk's output.

    Committed position p is token t = t_after[p] - 1 of flag group t >> 5;
    its first byte sits at 4 * ((t >> 5) + 1) + data_before[p] (a 4-byte
    flag word per started group precedes the group's data).  The k-th
    nibble user (escape length) opens a fresh nibble byte after its token
    when k is even; the next one fills that byte's high half.  Every
    payload byte is written once, so each plane is one scatter.  Returns
    (payload, plen).
    """
    N, n = units.shape
    dev = units.device
    i32 = torch.int32
    iscp = committed & use_match
    L = best_len - MIN_MATCH
    nib_user = iscp & (L >= 7)
    nu_cum = nib_user.cumsum(1, dtype=i32)
    opens = nib_user & (((nu_cum - nib_user.int()) & 1) == 0)
    extra, rem, big = _match_extra_sizes(L, opens)
    tok_sz = torch.where(iscp, 2 + extra, committed.int())
    d_cum = tok_sz.cumsum(1, dtype=i32)
    data_before = d_cum - tok_sz
    t_after = committed.cumsum(1, dtype=i32)
    T_total = t_after[:, -1]
    t_idx = t_after - 1
    grp = t_idx >> 5
    off = 4 * (grp + 1) + data_before
    tokv = ((best_disp - 1) << 3) | L.clamp(max=7)
    nibval = rem.clamp(max=15)
    b0 = torch.where(iscp, tokv & 0xFF, units.int())

    # nibble pairing in nibble-index space (k = nu_cum - 1 of each user):
    # an opener deposits its low nibble and its nibble byte's position
    # (+1, so that 0 means "none"), a partner its nibble for k - 1's high
    # half
    kidx = nu_cum - 1
    is_open = nib_user & opens
    is_part = nib_user & ~opens
    mlow, mpos1 = place_monotone(~is_open, torch.where(is_open, kidx, -1),
                                 (nibval, off + 3), n)
    mhigh = place_monotone(~is_part, torch.where(is_part, kidx - 1, -1),
                           nibval, n)
    nibbyte = mlow | (mhigh << 4)

    # group flag words, in group-index space: bit 31 - (t & 31) marks a
    # match (int64: bit 31 is int32's sign bit); the absent tokens of the
    # last group are 1 bits, the low 32 - count of its word
    NG = n // 32
    gq = torch.arange(NG, device=dev)[None, :]
    one = torch.ones((), dtype=torch.int64, device=dev)
    fbits = scatter_sorted_or(
        grp, torch.where(iscp, one << (31 - (t_idx & 31)).long(), 0), NG)
    ngroups = (T_total + 31) >> 5
    grp_exists = gq < ngroups[:, None]
    cnt_g = (T_total[:, None] - gq * 32).clamp(0, 32)
    fv = fbits | ((one << (32 - cnt_g)) - 1)
    fpos1 = place_monotone(~(committed & ((t_idx & 31) == 0)), grp, off - 3,
                           NG)  # = the flag word's position + 1

    # escape bytes after the token: [nibble (if it opens)] [byte | 0xFF]
    # [u16 lo, hi] [u32 b0..b3], every one gated on the committed parse
    esc0 = off + 2 + opens.int()
    has_esc = iscp & (rem >= 15)
    has_big = iscp & big
    esc_bv = torch.where(big, 255, (rem - 15).clamp(min=0))
    u16v = torch.where(L < 0x10000, L, 0)
    has_u32 = has_big & (L >= 0x10000)

    MAXP = max_payload(n)
    tok_planes = place_monotone(
        ~committed, off, (torch.where(committed, b0, 0),
                          torch.where(iscp, tokv >> 8, 0)), MAXP)
    esc_vals = (torch.where(has_esc, esc_bv, 0),
                torch.where(has_big, u16v & 0xFF, 0),
                torch.where(has_big, u16v >> 8, 0)) + tuple(
        torch.where(has_u32, (L >> (8 * k)) & 0xFF, 0) for k in range(4))
    esc_planes = place_monotone(~has_esc, esc0, esc_vals, MAXP)
    nib_plane = place_monotone(mpos1 == 0, mpos1 - 1, nibbyte, MAXP)
    flag_planes = place_monotone(
        ~grp_exists, fpos1 - 1,
        tuple(((fv >> (8 * k)) & 0xFF).to(i32) for k in range(4)), MAXP)
    val = (rolled_or(tok_planes) | rolled_or(esc_planes) | nib_plane
           | rolled_or(flag_planes))
    plen = torch.where(T_total > 0, 4 * ngroups + d_cum[:, -1], 0).to(i32)
    bq = torch.arange(MAXP, device=dev)[None, :]
    payload = torch.where(bq < plen[:, None], val, 0).to(torch.uint8)
    return payload, plen


def compress_units(units, unit_size=UNIT, *, device="cuda") -> list:
    """Compress independent units of at most ``unit_size`` bytes in one
    device batch, one stream per unit, as tpucomp's ``compress_units``
    (which slices the batch at 128 rows of 64 KiB for its compiler; the
    slices do not change a unit's bytes).  An empty unit gives ``b""``.
    """
    dev = resolve_device(device)
    _check_unit_size(unit_size)
    units = [bytes(u) for u in units]
    if not units:
        return []
    if any(len(u) > unit_size for u in units):
        raise ArgError("unit larger than unit_size")
    return row_streams(*encode_batch(*unit_rows(units, unit_size, dev)))


def compress(data: bytes, *, device="cuda") -> bytes:
    """One-shot plain Xpress encode of at most 64 KiB, as one unit of 4,
    16 or 64 KiB: tpucomp's ``compress`` at its default config.  Larger
    input takes tpucomp's single-stream encoder, not ported yet."""
    data = bytes(data)
    if not data:
        return b""
    if len(data) > UNIT:
        raise UnsupportedFormatError(
            "compress of XPRESS input over 64 KiB (tpucomp's single-stream "
            "encoder, compress_stream) is not ported to tpucomp_torch yet")
    return compress_units([data], unit_size=_oneshot_unit(len(data)),
                          device=device)[0]

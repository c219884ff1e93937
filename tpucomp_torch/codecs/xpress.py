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

The one-shot calls take buffers of at most 64 KiB as one unit of 4, 16
or 64 KiB, as tpucomp's device backend does.  ``compress`` of a larger
buffer runs the single-stream encoder (:func:`compress_stream`,
tpucomp's): the same pipeline over rows of [8 KiB history | 64 KiB
lane], 73,728 wide, with the stream's flag and nibble state carried
across lanes and dispatches.  One-shot decode over 64 KiB is host work
in tpucomp too (a plain Xpress stream has no block boundaries).
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
from ..stats import count, span
from ..util import (any_set, resolve_device, row_bytes, row_streams,
                    staging_rows, to_device, to_host, unit_rows)
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


@span("xp.decode", "compute")
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


@span("xp.pack_units", "stage")
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
    payload = staging_rows(N, P, device)
    plen = np.zeros(N, np.int32)
    for i, s in enumerate(streams):
        payload[i, :len(s)] = np.frombuffer(s, np.uint8)
        payload[i, len(s):] = 0
        plen[i] = len(s)
    return tuple(to_device(a, device) for a in (
        payload, plen, np.asarray(out_lens, np.int32)))


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
    batch = pack_units(streams, out_lens, unit_size, dev)
    count("xp.units", len(streams))
    out, err = decode_batch(*batch, unit_size)
    if any_set(err, "sync.xp_err"):
        raise DataError("Xpress: malformed unit stream")
    out = to_host(out, "sync.xp_output", pinned=True)
    with span("xp.split_output", "stage"):
        units = row_bytes(out, out_lens)
        del out  # the host rows are freed in the stage
    return units


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
    with span("xp.find_matches", "compute"):
        best_len, best_disp, use_match, okpos = find_matches(units, ulen,
                                                             match)
    with span("xp.greedy_commit", "compute"):
        committed = greedy_commit(use_match, best_len, okpos)
    with span("xp.assemble_payload", "compute"):
        return assemble_payload(units, best_len, best_disp, use_match,
                                committed)


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
    N, n = units.shape
    if units.dtype != torch.uint8 or units.dim() != 2 or not 0 < n <= UNIT:
        raise ValueError(f"units must be a uint8 [N, n <= {UNIT}] tensor")
    if ulen.dtype != torch.int32 or tuple(ulen.shape) != (N,):
        raise ValueError("ulen must be an int32 [N] tensor")
    best_len, best_disp = best_candidates(units, match, max_disp)
    return walk_inputs(best_len, best_disp, ulen)


def best_candidates(x: torch.Tensor, match: MatchFinderConfig | None,
                    max_disp: int | None, source_ok=None):
    """The candidate search of the match finders over rows ``x`` (uint8
    [N, w]): runs for each d of ``match.run_disps``, then the hash
    match(es); a later candidate wins only with a strictly longer length.
    ``source_ok(disp)``, where given, is a bool mask of the positions
    whose match at ``disp`` may count (the stream encoder's: no source in
    the zeros before the stream).  Returns (best_len, best_disp), int32
    [N, w], unclipped."""
    match = DEFAULT if match is None else match
    N, w = x.shape
    best_len = torch.zeros((N, w), dtype=torch.int32, device=x.device)
    best_disp = torch.ones((N, w), dtype=torch.int32, device=x.device)

    def consider(length, disp):
        nonlocal best_len, best_disp
        better = (length >= MIN_MATCH) & (length > best_len)
        if source_ok is not None:
            better = better & source_ok(disp)
        best_len = torch.where(better, length, best_len)
        best_disp = torch.where(better, disp, best_disp)

    run_disps = tuple(match.run_disps)
    for d, ml in zip(run_disps, run_matchlens(x, run_disps)):
        consider(ml, d)
    passes = [(match.num_candidates, 3)]
    if match.second_hash_cands:
        passes.append((match.second_hash_cands, 5))
    for num_cands, seed in passes:
        hl, hd = hash_best_match(x, w, hash_bits=match.hash_bits,
                                 num_cands=num_cands, cap=match.cap,
                                 max_disp=max_disp, seed=seed)
        # exact lengths past the compare cap (the reference is uncapped)
        consider(extend_saturated(hl, hd, match.cap, w), hd)
    return best_len, best_disp


def walk_inputs(best_len, best_disp, ulen):
    """The lengths clipped to each unit and the lazy step: defer a match
    when the next position has a strictly longer one.  Returns the
    walk's inputs (best_len, best_disp, use_match, okpos) as
    :func:`find_matches`."""
    N, n = best_len.shape
    pos = torch.arange(n, dtype=torch.int32, device=best_len.device)[None, :]
    in_len = ulen[:, None]
    best_len = torch.minimum(best_len, in_len - pos)
    is_match = (best_len >= MIN_MATCH) & (pos + MIN_MATCH <= in_len)
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


def _token_bytes(committed, iscp, off, b0, tokv, L, rem, big, opens, MAXP):
    """The bytes of every committed token from its first byte's offset
    ``off``: the literal or the match's two token bytes, then the escape
    bytes [nibble (if it opens; written by the caller)] [byte | 0xFF]
    [u16 lo, hi] [u32 b0..b3], every one gated on the committed parse.
    Returns int32 [N, MAXP], 0 elsewhere."""
    esc0 = off + 2 + opens.int()
    has_esc = iscp & (rem >= 15)
    has_big = iscp & big
    esc_bv = torch.where(big, 255, (rem - 15).clamp(min=0))
    u16v = torch.where(L < 0x10000, L, 0)
    has_u32 = has_big & (L >= 0x10000)
    tok_planes = place_monotone(
        ~committed, off, (torch.where(committed, b0, 0),
                          torch.where(iscp, tokv >> 8, 0)), MAXP)
    esc_vals = (torch.where(has_esc, esc_bv, 0),
                torch.where(has_big, u16v & 0xFF, 0),
                torch.where(has_big, u16v >> 8, 0)) + tuple(
        torch.where(has_u32, (L >> (8 * k)) & 0xFF, 0) for k in range(4))
    esc_planes = place_monotone(~has_esc, esc0, esc_vals, MAXP)
    return rolled_or(tok_planes) | rolled_or(esc_planes)


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

    MAXP = max_payload(n)
    nib_plane = place_monotone(mpos1 == 0, mpos1 - 1, nibbyte, MAXP)
    flag_planes = place_monotone(
        ~grp_exists, fpos1 - 1,
        tuple(((fv >> (8 * k)) & 0xFF).to(i32) for k in range(4)), MAXP)
    val = (_token_bytes(committed, iscp, off, b0, tokv, L, rem, big, opens,
                        MAXP) | nib_plane | rolled_or(flag_planes))
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
    count("xp.units", len(units))
    return row_streams(*encode_batch(*unit_rows(units, unit_size, dev)))


# --------------------------------------------------------------------------
# Single-stream encode of any length
# --------------------------------------------------------------------------
#
# tpucomp's ``compress_stream`` / ``_encode_stream_impl``: ONE [MS-XCA]
# §2.3 stream for a whole buffer, cut into lanes of ``unit_size`` bytes.
# Each lane's row is [the 8 KiB before it | its bytes], so matches reach
# back across lane boundaries; tokens, nibble users, flag groups and bytes
# are numbered over the whole stream by two-level cumsums (within a lane,
# then over lanes).  Two lane scans link the lanes: a lane that ends on an
# unpartnered nibble opener takes the next users-lane's first nibble
# (:func:`next_from_right`), and a flag group that spans lanes gets its
# later lanes' bits (:func:`segmented_suffix_or`).  Dispatches of at most
# ``ENCODE_BATCH_CAP`` rows of 64 KiB carry four values on the host (the
# token phase mod 32, the nibble parity, the last flag word's offset and a
# pending nibble byte) and patch at most 5 bytes already written.

# tpucomp's ``config.encode_batch_cap``: a dispatch takes at most this many
# rows of 64 KiB (lanes: the byte budget over the unit, a multiple of 8)
ENCODE_BATCH_CAP = 128


def stream_lanes(unit_size: int) -> int:
    """Lanes a dispatch of :func:`compress_stream` takes (tpucomp's
    ``max(8, encode_batch_cap * 65536 // U // 8 * 8)``)."""
    return max(8, ENCODE_BATCH_CAP * UNIT // unit_size // 8 * 8)


def next_from_right(has: torch.Tensor, val: torch.Tensor):
    """Over lanes: (nxt_has, nxt_val)[i] = (True, val[j]) for the smallest
    j > i with has[j], (False, 0) where there is none (tpucomp's
    ``_next_from_right``): a flipped ``cummin`` of the lanes that have."""
    N = has.shape[0]
    lane = torch.arange(N, dtype=torch.int64, device=has.device)
    first = torch.where(has, lane, N).flip(0).cummin(0).values.flip(0)
    nxt = torch.cat([first[1:], first.new_full((1,), N)])
    nxt_has = nxt < N
    nxt_val = torch.where(nxt_has, val[nxt.clamp(max=N - 1)], 0)
    return nxt_has, nxt_val


def segmented_suffix_or(key: torch.Tensor, contrib: torch.Tensor):
    """Over lanes: acc[i] = the OR of contrib[j] for j >= i in the run of
    equal keys that holds i (tpucomp's associative scan ``comb2``).  The
    contributions of one run share no bit (each is a lane's own token
    bits of one flag group), so the OR is a sum: the run's last inclusive
    cumsum less the cumsum before i.  ``contrib``: int64, non-negative."""
    seg = torch.cat([key.new_zeros(1), (key[1:] != key[:-1]).long()]).cumsum(0)
    inc = contrib.cumsum(0)
    run_end = torch.zeros_like(inc).scatter_reduce(0, seg, inc, "amax")
    return run_end[seg] - (inc - contrib)


def stream_find_matches(units, ulen, hist0, h0v: int,
                        match: MatchFinderConfig | None = None):
    """Match finding of one dispatch of the stream encoder (tpucomp's
    ``_encode_stream_impl`` up to its walk), over the rows [8 KiB history |
    lane]: lane i's history is lane i - 1's last 8 KiB, lane 0's
    ``hist0`` (uint8 [8192]), real if ``h0v`` (else zeros before the
    stream, which no match may reach).  Returns the walk's inputs for the
    lanes' own columns, as :func:`find_matches`."""
    N, n = units.shape
    H = WINDOW
    if units.dtype != torch.uint8 or not H <= n <= UNIT:
        raise ValueError(f"units must be a uint8 [N, {H} <= n <= {UNIT}] "
                         "tensor")
    xext = torch.cat([torch.cat([hist0[None], units[:-1, -H:]]), units], 1)
    lane = torch.arange(N, device=units.device)
    hval = ((lane > 0) | bool(h0v))[:, None]
    pe = torch.arange(H + n, dtype=torch.int32, device=units.device)
    best_len, best_disp = best_candidates(
        xext, match, WINDOW, lambda disp: hval | (pe - disp >= H))
    return walk_inputs(best_len[:, H:], best_disp[:, H:], ulen)


def assemble_stream(units, best_len, best_disp, use_match, committed,
                    t0: int, k0: int):
    """The byte assembly of one dispatch of the stream encoder, in the
    stream's global token, nibble, group and byte coordinates (tpucomp's
    ``_encode_stream_impl`` after its walk).  ``t0``: the stream's tokens
    before this dispatch, mod 32; ``k0``: its nibble users', mod 2.

    Returns tpucomp's nine outputs: payload (uint8 [N, max_payload(n) +
    8], each lane's bytes from its first, 0 past plen), plen (int32 [N]),
    and 0-d tensors Ttot, Ktot (the tokens and nibble users up to the
    dispatch's end, t0 and k0 included), head0 (the bits of the previous
    dispatch's open flag group, int64), lastf (the dispatch's last flag
    word's offset, -1 for none), dangp (the offset of its unpartnered
    nibble byte, -1 for none), fu_val and fu_has (its first nibble)."""
    N, n = units.shape
    dev = units.device
    i32 = torch.int32
    lanes = torch.arange(N, dtype=i32, device=dev)
    iscp = committed & use_match
    L = best_len - MIN_MATCH

    # global token / nibble / byte coordinates (two-level cumsums)
    nib_user = iscp & (L >= 7)
    nu_inc = nib_user.cumsum(1, dtype=i32)
    nu_tot = nu_inc[:, -1]
    Koff = nu_tot.cumsum(0, dtype=i32) - nu_tot + k0
    kidx = nu_inc - nib_user.int() + Koff[:, None]
    opens = nib_user & ((kidx & 1) == 0)
    extra, rem, big = _match_extra_sizes(L, opens)
    tok_sz = torch.where(iscp, 2 + extra, committed.int())
    d_cum = tok_sz.cumsum(1, dtype=i32)
    data_before = d_cum - tok_sz
    dt = d_cum[:, -1]
    Doff = dt.cumsum(0, dtype=i32) - dt
    t_after = committed.cumsum(1, dtype=i32)
    Tl = t_after[:, -1]
    Toff = Tl.cumsum(0, dtype=i32) - Tl + t0
    t_g = t_after - 1 + Toff[:, None]
    grp = t_g >> 5
    G0w = (t0 + 31) >> 5  # flag words living in earlier dispatches
    off_c = 4 * (grp + 1 - G0w) + data_before + Doff[:, None]
    Bv = 4 * ((Toff >> 5) + ((Toff & 31) != 0).int() - G0w) + Doff
    offl = off_c - Bv[:, None]
    Ttot = Toff[-1] + Tl[-1]
    Ktot = Koff[-1] + nu_tot[-1]
    Bend = (4 * ((Ttot >> 5) + ((Ttot & 31) != 0).int() - G0w) + Doff[-1]
            + dt[-1])
    plen = torch.cat([Bv[1:], Bend[None]]) - Bv

    tokv = ((best_disp - 1) << 3) | L.clamp(max=7)
    nibval = rem.clamp(max=15)
    b0 = torch.where(iscp, tokv & 0xFF, units.int())
    MAXPG = max_payload(n) + 8

    # nibble pairing in global pair space, localised to each lane
    pl_pair = (kidx >> 1) - (Koff >> 1)[:, None]
    is_part = nib_user & ~opens
    PAIRS = n // 2 + 2
    mlow, mpos1 = place_monotone(~opens, pl_pair, (nibval, offl + 3), PAIRS)
    mhigh = place_monotone(~is_part, pl_pair, nibval, PAIRS)
    nib_plane = place_monotone(mpos1 == 0, mpos1 - 1, mlow | (mhigh << 4),
                               MAXPG)
    # a lane ending on an unpartnered opener takes the next users-lane's
    # first nibble into that byte's high half
    lane_users = nu_tot > 0
    dang_lane = lane_users & (((Koff + nu_tot - 1) & 1) == 0)
    last_user = nib_user & (nu_inc == nu_tot[:, None])
    dang_pos = torch.where(last_user & opens, offl + 2, 0).sum(1, dtype=i32)
    first_user = nib_user & (nu_inc == 1)
    fval = torch.where(first_user, nibval, 0).sum(1, dtype=i32)
    nxt_has, nxt_val = next_from_right(lane_users, fval)
    patch_v = torch.where(dang_lane & nxt_has, nxt_val << 4, 0)
    dangp = torch.where(dang_lane & ~nxt_has, Bv + dang_pos, -1).max()
    fu_val = fval[lane_users.int().argmax()]
    fu_has = lane_users.any()

    # flag words in global group space, localised to each lane; bit 31 -
    # (t & 31) marks a match (int64: bit 31 is int32's sign bit)
    NGL = n // 32 + 2
    gl = grp - (Toff >> 5)[:, None]
    one = torch.ones((), dtype=torch.int64, device=dev)
    bits = torch.where(iscp, one << (31 - (t_g & 31)).long(), 0)
    fb_loc = scatter_sorted_or(gl, bits, NGL)  # before a first token: -1
    # a group that spans lanes: its later lanes' bits go to the lane that
    # holds its flag word
    key = torch.where(Tl > 0, Toff >> 5, (1 << 28) + lanes)
    contrib = torch.where((Tl > 0) & ((Toff & 31) != 0), fb_loc[:, 0], 0)
    acc = segmented_suffix_or(key, contrib)
    accn = torch.cat([acc[1:], acc.new_zeros(1)])
    keyn = torch.cat([key[1:], key.new_full((1,), -7)])
    G_last = torch.where(Tl > 0, (Toff + Tl - 1) >> 5, -9)
    incoming = torch.where(keyn == G_last, accn, 0)
    gl_last = torch.where(Tl > 0, G_last - (Toff >> 5), -1)
    colg = torch.arange(NGL, device=dev)[None, :]
    fb_loc = fb_loc | torch.where(colg == gl_last[:, None], incoming[:, None],
                                  0)
    # bits this dispatch adds to the previous one's open group; the final
    # word's pad bits are the host's, at the end of the stream
    head0 = torch.where((key[0] == 0) & (t0 & 31 != 0), acc[0], 0)
    gfirst = committed & ((t_g & 31) == 0)
    fpos1 = place_monotone(~gfirst, gl, offl - 3, NGL)
    flag_planes = place_monotone(
        fpos1 == 0, fpos1 - 1,
        tuple(((fb_loc >> (8 * k)) & 0xFF).to(i32) for k in range(4)), MAXPG)
    lastf = torch.where(gfirst, off_c - 4, -1).max()

    val = (_token_bytes(committed, iscp, offl, b0, tokv, L, rem, big, opens,
                        MAXPG) | nib_plane | rolled_or(flag_planes))
    at = dang_pos.long()[:, None]
    val = val.scatter(1, at, val.gather(1, at) | patch_v[:, None])
    bq = torch.arange(MAXPG, device=dev)[None, :]
    payload = torch.where(bq < plen[:, None], val, 0).to(torch.uint8)
    return (payload, plen, Ttot, Ktot, head0, lastf, dangp, fu_val, fu_has)


def encode_stream_chunk(units, ulen, hist0, h0v: int, t0: int, k0: int,
                        match: MatchFinderConfig | None = None):
    """One dispatch of the stream encoder, tpucomp's
    ``_encode_stream_impl(units, ulen, hist0, h0v, t0, k0, n)``:
    :func:`stream_find_matches`, the greedy walk, then
    :func:`assemble_stream`, whose nine outputs it returns.  ``units``
    (uint8 [N, n], 8192 <= n <= 65536) are consecutive lanes of one
    buffer, all full but the last."""
    bl, bd, use_match, okpos = stream_find_matches(units, ulen, hist0, h0v,
                                                   match)
    committed = greedy_commit(use_match, bl, okpos)
    return assemble_stream(units, bl, bd, use_match, committed, t0, k0)


def _check_stream_unit(unit_size: int) -> None:
    if not WINDOW <= unit_size <= UNIT:
        raise ArgError(f"the stream encoder's unit_size must lie in "
                       f"[{WINDOW}, {UNIT}], got {unit_size}")


def stream_rows(buf: np.ndarray, c0: int, N: int, U: int, dev):
    """Dispatch rows from lane ``c0`` on: the 8 KiB before it and its N
    lanes, one upload.  Returns (units uint8 [N, U], ulen int32 [N],
    hist0 uint8 [8192], h0v)."""
    H = WINDOW
    a, b = c0 * U, min(len(buf), (c0 + N) * U)
    flat = np.zeros(H + N * U, np.uint8)
    flat[H - min(a, H):H + b - a] = buf[max(0, a - H):b]
    flat = torch.from_numpy(flat).to(dev)
    lane = torch.arange(N, dtype=torch.int32, device=dev)
    ulen = ((b - a) - lane * U).clamp(0, U).to(torch.int32)
    return flat[H:].view(N, U), ulen, flat[:H], int(c0 > 0)


def _fetch(chunk):
    """The dispatch's stream bytes (each lane's first plen, in order) and
    its seven scalars, in one copy to the host."""
    payload, plen = chunk[:2]
    bq = torch.arange(payload.shape[1], device=payload.device)[None, :]
    scal = torch.stack([t.long() for t in chunk[2:]])
    host = torch.cat([scal.view(torch.uint8),
                      payload[bq < plen[:, None]]]).cpu().numpy()
    return host[56:], [int(v) for v in host[:56].view(np.int64)]


def _call(name: str, fn):
    return fn()


def compress_stream(data: bytes, unit_size: int = UNIT, *, device="cuda",
                    step=_call) -> bytes:
    """Compress ``data`` of any length into ONE [MS-XCA] §2.3 plain Xpress
    stream, as tpucomp's ``compress_stream``: lanes of ``unit_size``
    bytes (8192 to 65536, else :class:`ArgError`) whose matches reach
    back 8 KiB across lane boundaries, the flag and nibble state running
    through the whole stream.  Dispatches of :func:`stream_lanes` lanes;
    the bytes do not depend on it.  An empty input gives ``b""``, whatever
    ``unit_size``.

    ``step(name, fn)`` runs each step of a dispatch (``fn()``) and returns
    what it returns; a caller may pass one that times them."""
    dev = resolve_device(device)
    data = bytes(data)
    if not data:  # before the unit check, as tpucomp's
        return b""
    _check_stream_unit(unit_size)
    U = unit_size
    buf = np.frombuffer(data, np.uint8)
    lanes = -(-len(data) // U)
    cap = stream_lanes(U)
    out = bytearray()
    t_phase = k_par = 0
    pend_flag = pend_nib = None  # offsets of the last flag word, a nibble
    for c0 in range(0, lanes, cap):
        N = min(cap, lanes - c0)
        units, ulen, hist0, h0v = step(
            "rows and upload", lambda: stream_rows(buf, c0, N, U, dev))
        found = step("finder", lambda: stream_find_matches(units, ulen,
                                                           hist0, h0v))
        committed = step("walk", lambda: greedy_commit(found[2], found[0],
                                                       found[3]))
        chunk = step("assembly", lambda: assemble_stream(
            units, found[0], found[1], found[2], committed, t_phase, k_par))
        del found, committed
        got, (Ttot, Ktot, head0, lastf, dangp, fu_val, fu_has) = step(
            "copy back", lambda: _fetch(chunk))
        del chunk

        def patch():
            nonlocal pend_flag, pend_nib
            base = len(out)
            if head0 and pend_flag is not None:
                w = int.from_bytes(out[pend_flag:pend_flag + 4], "little")
                out[pend_flag:pend_flag + 4] = (w | head0).to_bytes(4,
                                                                    "little")
            if fu_has and pend_nib is not None:
                out[pend_nib] |= (fu_val << 4) & 0xF0
                pend_nib = None
            out.extend(got.tobytes())
            if lastf >= 0:
                pend_flag = base + lastf
            if fu_has:  # nibble users here: the parity may have flipped
                pend_nib = base + dangp if Ktot & 1 else None

        step("patches", patch)
        t_phase, k_par = Ttot & 31, Ktot & 1
    if t_phase and pend_flag is not None:
        # the final flag word: its absent tokens' bits are 1s
        w = int.from_bytes(out[pend_flag:pend_flag + 4], "little")
        out[pend_flag:pend_flag + 4] = (w | ((1 << (32 - t_phase)) - 1)
                                        ).to_bytes(4, "little")
    return bytes(out)


def compress(data: bytes, *, device="cuda") -> bytes:
    """One-shot plain Xpress encode, as tpucomp's ``compress``: at most
    64 KiB as one unit of 4, 16 or 64 KiB; larger input as one stream
    through :func:`compress_stream` at 64 KiB lanes."""
    data = bytes(data)
    if not data:
        return b""
    if len(data) > UNIT:
        return compress_stream(data, device=device)
    return compress_units([data], unit_size=_oneshot_unit(len(data)),
                          device=device)[0]

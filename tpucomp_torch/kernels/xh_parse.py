"""Xpress Huffman decode parse: the canonical-Huffman byte machine, one
block per row, decoded in segments at once.

Counterpart of ``tpucomp/kernels/xh_pallas.py`` ``parse_records`` ([MS-XCA]
§2.2).  :func:`xh_parse` launches ``csrc/xh_parse.cu`` on CUDA tensors and
runs :func:`xh_parse_ref` on CPU tensors.

Each body byte is one step: the low or high byte of a 16-bit refill word,
or a length-escape byte.  After a refill that completes the 32-bit prime
(step 3 on), or after an escape completes a match, up to ``SS[n]``
substeps each finish a pending match offset, then decode a fresh symbol
from the top 15 bits of the window.

Record layout (free in tpucomp, ``xh_pallas.py:23-29``): record k of a row
is in slot k of the ``[N, U]`` planes.  ``rec_pos`` is its output position,
``rec_val`` the literal symbol or ``COPY_BIT | offset``; empty slots hold
``SENT`` and 0.  Positions strictly increase along a row, so a row has at
most ``out_len <= U`` records.

The history variant of tpucomp's XLA scan (``make_decoder(...,
want_span=True, with_history=True)``, ``codecs/xpress_huff.py:170-390``),
which the one-shot multi-block decode runs, adds two things: each row's
history reach ``hist_len`` (an offset may reach that many bytes before
the block's start: the check is ``offset > p + hist_len``), and its byte
span, ``2 * (2 + max(0, ceil(bits / 16) - 1)) + raw``, from the code and
offset bits the row consumed and its escape bytes, counted while the row
is active (before the body's end and before out_len): where the next
block starts.

The kernel cuts each body into segments (:func:`segments`), decodes them
all at once from guessed entry states, and re-decodes in rounds those
whose true entry (the exit of the segment before) differs, until none
does; tier-3 rows (every code 8 bits or more, where a wrong guess never
resynchronises) decode each segment under ``HYP`` entry hypotheses
instead and resolve them left to right.  Exact on every input
(``tests/test_torch_xh_segment.py`` models it in numpy).  The wrapper
keeps each row's count of rounds (tier 3: segments re-decoded) of its
last launch as ``xh_parse.rounds`` (int32 [N] on the card), as it keeps
``launches``.
"""

from __future__ import annotations

import torch

from .. import stats
from . import _build
from .common import MAX_ROW, SENT_KEY

MIN_MATCH = 3
COPY_BIT = 1 << 20
SENT = SENT_KEY

# byte roles and pending states, as in tpucomp's xh_pallas
_M_W0, _M_W1, _M_EB, _M_E16A, _M_E16B = 0, 1, 2, 3, 4
_M_E32A, _M_E32B, _M_E32C, _M_E32D = 5, 6, 7, 8
_P_NONE, _P_OFFSET, _P_ESC = 0, 1, 2

# the kernel's geometry: csrc/xh_parse.cu
THREADS = 256  # threads a row
HYP = 8  # entry hypotheses of a tier-3 segment (THREADS // HYP segments)
HYP_LO = 8  # their leftover bit counts: HYP_LO to HYP_LO + HYP - 1
WARM = 32  # bytes a segment decodes before its start for its first guess
SEG_MIN = 64  # least bytes of a segment, tier 3 aside
MAX_BODY = 160 << 10  # body bytes a row can stage in shared memory
REC = 7  # ints of a state a tier-3 hypothesis records for the final pass


def segments(blen: int, ss: int) -> tuple[int, int]:
    """(S, nseg): the kernel's segment length for a body of ``blen`` bytes
    at substep tier ``ss``, and its count of segments (0 when the body is
    empty).  S is 4 times an odd number, so that segments' words fall in
    different shared-memory banks, and at least ceil(blen / parts):
    ``THREADS // HYP`` parts at tier 3, else ``THREADS`` (and at least
    ``SEG_MIN`` bytes)."""
    if blen <= 0:
        return 0, 0
    parts = THREADS // HYP if ss == 3 else THREADS
    seg = max(-(-blen // parts), 1 if ss == 3 else SEG_MIN)
    S = 4 * ((-(-seg // 4)) | 1)
    return S, -(-blen // S)


def _check(body, blen, out_len, ss, lim15, rbf, sym_by_rank, U, hist_len):
    if body.dtype != torch.uint8 or body.dim() != 2:
        raise ValueError("body must be a uint8 [N, Pb] tensor")
    N = body.shape[0]
    for name, t, shape in (("blen", blen, (N,)), ("out_len", out_len, (N,)),
                           ("ss", ss, (N,)), ("lim15", lim15, (N, 16)),
                           ("rbf", rbf, (N, 16)),
                           ("sym_by_rank", sym_by_rank, (N, 512)),
                           ("hist_len", hist_len, (N,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be an int32 {list(shape)} tensor")
    if not 0 < U <= MAX_ROW:
        raise ValueError(f"U must lie in (0, {MAX_ROW}]")


def _shl(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int32 ``x << s`` with XLA's rule for a shift outside [0, 32): 0."""
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, x << s.clamp(0, 31), 0)


def _hist_len(hist_len, body):
    """``hist_len``, or a reach of 0 for every row."""
    if hist_len is None:
        return torch.zeros(body.shape[0], dtype=torch.int32,
                           device=body.device)
    return hist_len


def span_of(bits: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """A block's byte span from the code and offset bits it consumed and
    its escape bytes: two priming words, one more word for each 16 bits
    after the first word's, and the escape bytes (tpucomp's
    ``_decode_impl``, the oracle's ``_block_byte_span``)."""
    return 2 * (2 + ((bits + 15) // 16 - 1).clamp(min=0)) + raw


def xh_parse_ref(body, blen, out_len, ss, lim15, rbf, sym_by_rank, U,
                 hist_len=None, want_span=False):
    """Plain PyTorch version of :func:`xh_parse`: a Python loop over body
    steps, vectorised over rows, each row's substep count ``ss`` a mask.
    Substeps stop once no row can consume anything, which changes
    nothing: such a substep leaves every row as it was."""
    hl = _hist_len(hist_len, body)
    _check(body, blen, out_len, ss, lim15, rbf, sym_by_rank, U, hl)
    N, Pb = body.shape
    dev = body.device
    i32 = dict(dtype=torch.int32, device=dev)
    z = torch.zeros(N, **i32)
    (p, mode, pend, bitbuf, bitcount, lowbyte, obc_p, lh_p, off_p, len_acc,
     err, cnt, bits, esc_bytes) = (z.clone() for _ in range(14))
    # one spare column U takes the writes of rows without a record
    rec_pos = torch.full((N, U + 1), SENT, **i32)
    rec_val = torch.zeros((N, U + 1), **i32)
    lim15_lo = lim15[:, 1:15]
    lim15_top = lim15[:, 15]
    blen = blen.clamp(max=Pb)
    olen = out_len

    def record(made, pos, val):
        nonlocal cnt
        slot = torch.where(made & (cnt < U), cnt, U).long()[:, None]
        rec_pos.scatter_(1, slot, pos[:, None])
        rec_val.scatter_(1, slot, val[:, None])
        cnt = cnt + made.int()

    steps = int(blen.max()) if N else 0
    max_ss = int(ss.max()) if N else 0
    body = body.to(torch.int32)
    for s in range(steps):
        active = (s < blen) & (p < olen)
        if not bool(active.any()):
            break
        b = body[:, s]
        is_w0 = active & (mode == _M_W0)
        is_w1 = active & (mode == _M_W1)
        is_eb = active & (mode == _M_EB)
        is_e16a = active & (mode == _M_E16A)
        is_e16b = active & (mode == _M_E16B)
        is_e32nd = active & (mode >= _M_E32A) & (mode < _M_E32D)
        is_e32d = active & (mode == _M_E32D)

        lowbyte = torch.where(is_w0, b, lowbyte)
        # the span counts every escape-role byte
        esc_bytes = esc_bytes + (is_eb | is_e16a | is_e16b | is_e32nd
                                 | is_e32d).int()
        len_acc = torch.where(
            is_e16a | (active & (mode == _M_E32A)), b,
            torch.where(active & (mode == _M_E32B), len_acc | (b << 8),
                        torch.where(active & (mode == _M_E32C),
                                    len_acc | (b << 16), len_acc)))
        word = lowbyte | (b << 8)
        bitbuf = torch.where(is_w1, bitbuf | _shl(word, 16 - bitcount),
                             bitbuf)
        bitcount = bitcount + is_w1.int() * 16

        eb_done = is_eb & (b < 255)
        eb_more = is_eb & (b == 255)
        u16v = len_acc | (b << 8)
        e16_zero = is_e16b & (u16v == 0)
        e16_done = is_e16b & (u16v != 0)
        u32v = len_acc | (b << 24)  # int32: wraps, as in tpucomp
        esc_len = torch.where(
            eb_done, b + 15 + MIN_MATCH,
            torch.where(e16_done, u16v + MIN_MATCH,
                        torch.where(is_e32d, u32v + MIN_MATCH, 0)))
        esc_match = eb_done | e16_done | is_e32d
        err = err | (esc_match & ((off_p > p + hl)
                                  | (p + esc_len > olen))).int()
        record(esc_match, p, COPY_BIT | off_p)
        p = torch.where(esc_match, torch.clamp(p + esc_len, max=U), p)
        mode = torch.where(
            is_w0, _M_W1,
            torch.where(eb_more, _M_E16A,
                        torch.where(is_e16a, _M_E16B,
                                    torch.where(e16_zero, _M_E32A,
                                                torch.where(is_e32nd, mode + 1,
                                                            torch.where(active, _M_W0,
                                                                        mode)))))).int()
        pend = torch.where(esc_match, _P_NONE, pend)

        # the 32-bit prime: no symbol before the second word (s >= 3)
        can_work = active & (esc_match | (is_w1 & (s >= 3)))
        if not bool(can_work.any()):
            continue  # no row decodes, flags or changes mode below
        work = can_work
        for j in range(max_ss):
            work_j = work & (j < ss)
            do_off = work_j & (pend == _P_OFFSET) & (bitcount >= obc_p)
            could_sym = work_j & (pend == _P_NONE) & (bitcount >= 16)
            if not bool((do_off | could_sym).any()):
                break
            # 1) the pending match's offset bits
            obc_c = obc_p.clamp(min=1)
            raw = (bitbuf >> (32 - obc_c)) & ((1 << obc_c) - 1)
            offv = (1 << obc_p) | torch.where(obc_p > 0, raw, 0)
            bitbuf = torch.where(do_off, bitbuf << obc_p, bitbuf)
            bitcount = bitcount - do_off.int() * obc_p
            bits = bits + do_off.int() * obc_p
            short = do_off & (lh_p < 15)
            mlen = lh_p + MIN_MATCH
            err = err | (short & ((offv > p + hl) | (p + mlen > olen))).int()
            record(short, p, COPY_BIT | offv)
            p = torch.where(short, torch.clamp(p + mlen, max=U), p)
            off_p = torch.where(do_off, offv, off_p)
            pend = torch.where(short, _P_NONE,
                               torch.where(do_off, _P_ESC, pend)).int()
            # 2) a fresh symbol
            do_sym = work_j & (pend == _P_NONE) & (bitcount >= 16) & (p < olen)
            peek15 = (bitbuf >> 17) & 0x7FFF
            level = 1 + (peek15[:, None] >= lim15_lo).sum(dim=1,
                                                          dtype=torch.int32)
            found = peek15 < lim15_top
            rank = rbf.gather(1, level.long()[:, None])[:, 0] \
                + (peek15 >> (15 - level))
            ok = found & (rank >= 0) & (rank < 512)
            sym = torch.where(ok, sym_by_rank.gather(
                1, torch.where(ok, rank, 0).long()[:, None])[:, 0], 0)
            do_sym = do_sym & found
            bitbuf = torch.where(do_sym, bitbuf << level, bitbuf)
            bitcount = bitcount - do_sym.int() * level
            bits = bits + do_sym.int() * level
            is_lit = do_sym & (sym < 256)
            record(is_lit, p, sym)
            p = p + is_lit.int()
            is_m = do_sym & (sym >= 256)
            msym = sym - 256
            obc_p = torch.where(is_m, msym >> 4, obc_p)
            lh_p = torch.where(is_m, msym & 0xF, lh_p)
            pend = torch.where(is_m, _P_OFFSET, pend).int()
            work = work & (p < olen)

        # a refill that leaves decodable bits behind would desync the next
        # byte: flag it (SS[n] covers every valid row)
        leftover = can_work & (p < olen) & (
            ((pend == _P_NONE) & (bitcount >= 16))
            | ((pend == _P_OFFSET) & (bitcount >= obc_p)))
        err = err | leftover.int()
        mode = torch.where(
            can_work,
            torch.where((pend == _P_ESC) & (bitcount >= 16), _M_EB, _M_W0),
            mode).int()
    # more records than slots: only a row whose position moved backwards
    # (an escape length that wraps int32) gets here
    err = err | (cnt > U).int()
    out = (rec_pos[:, :U].contiguous(), rec_val[:, :U].contiguous(), p, err)
    return (*out, span_of(bits, esc_bytes)) if want_span else out


def xh_parse(body, blen, out_len, ss, lim15, rbf, sym_by_rank, U: int,
             hist_len=None, want_span=False):
    """Parse a batch of single-block XH bodies into token records.

    Args:
      body:   uint8 [N, Pb], the stream bytes after the 256-byte table.
      blen:   int32 [N], body length (may be negative: nothing to parse).
      out_len: int32 [N], the decoded length of each row, <= U.
      ss:     int32 [N], each row's substep count (``_substeps_for`` of its
              table's shortest code).
      lim15, rbf: int32 [N, 16], from :func:`huffman.level_tables`.
      sym_by_rank: int32 [N, 512], from :func:`huffman.rank_to_symbol_table`.
      U:      the output width of a row (record slots per row).
      hist_len: int32 [N] or None (0), how many bytes before the block's
              start an offset may reach (the history the row has).
      want_span: also return each row's byte span.

    Returns (rec_pos [N, U], rec_val [N, U], p_final [N], err [N]), and
    with ``want_span`` span [N], all int32: see the module docstring.
    ``p_final`` is the decoded length; ``err`` flags a match before the
    history's start or past ``out_len``, a refill that leaves decodable
    bits behind, and more records than slots.  ``span`` is exact on rows
    without err (tpucomp reads it on no other).
    """
    hl = _hist_len(hist_len, body)
    if not _build.use_kernel(body, blen, out_len, ss, lim15, rbf,
                             sym_by_rank, hl):
        return xh_parse_ref(body, blen, out_len, ss, lim15, rbf,
                            sym_by_rank, U, hl, want_span)
    _check(body, blen, out_len, ss, lim15, rbf, sym_by_rank, U, hl)
    ins = [t.contiguous() for t in (body, blen, out_len, ss, lim15, rbf,
                                    sym_by_rank, hl)]
    N, Pb = body.shape
    if Pb > MAX_BODY:
        raise ValueError(f"bodies of at most {MAX_BODY} bytes, not {Pb} (the "
                         "kernel stages a row's body in shared memory)")
    rec_pos = torch.empty((N, U), dtype=torch.int32, device=body.device)
    rec_val = torch.empty_like(rec_pos)
    p_final = torch.empty((N,), dtype=torch.int32, device=body.device)
    err = torch.empty_like(p_final)
    span = torch.empty_like(p_final)
    rounds = torch.empty_like(p_final)
    if N:
        # tier-3 rows take the longest: their blocks go first
        order = torch.argsort((ins[3] != 3).to(torch.uint8),
                              stable=True).to(torch.int32)
        # the states a tier-3 row records for its final pass (THREADS
        # hypotheses x HYP - 1 sub-segment starts), 49 KiB a row
        scratch = torch.empty((N, THREADS, HYP - 1, REC), dtype=torch.int32,
                              device=body.device)
        _build.launch("xh_parse", ins + [order, rec_pos, rec_val, p_final,
                                         err, span, rounds, scratch],
                      [N, Pb, U])
        stats.launched(xh_parse)
        xh_parse.rounds = rounds
    out = (rec_pos, rec_val, p_final, err)
    return (*out, span) if want_span else out


xh_parse.launches = 0
xh_parse.rounds = None

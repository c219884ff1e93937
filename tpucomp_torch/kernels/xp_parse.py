"""Plain Xpress decode parse: the 14-state byte machine, one unit per row.

Counterpart of ``tpucomp/kernels/xp_pallas.py`` ``parse_records`` and of
the XLA scan in ``tpucomp/codecs/xpress.py`` ``_decode_impl`` ([MS-XCA]
§2.4).  :func:`xp_parse` launches ``csrc/xp_parse.cu`` on CUDA tensors and
runs :func:`xp_parse_ref` on CPU tensors.  The kernel walks each row's
skeleton (flag word to flag word, in rounds of a warp) while three more
warps emit the records window by window behind it (see its source note);
it keeps each row's count of walk steps (flag words plus matches) of its
last launch as ``xp_parse.steps`` (int32 [N] on the card).

Each payload byte is one step: a byte of a little-endian 32-bit flag word
(consumed MSB first), a literal or a match's low byte, its high byte, a
shared nibble byte (its low half serves this match, its high half the
next one that needs a nibble), or a byte / u16 / u32 length escape.

Record layout: byte step ``s`` that completes a token writes
``rec_pos[n, s]`` = its output position and ``rec_val[n, s]`` = the
literal byte or ``COPY_BIT | offset``; empty slots hold ``SENT`` and 0.
tpucomp's Pallas kernel packs the same records into one plane
``((val << 16) | pos) + 1`` for the TPU's lanes; its XLA scan carries the
last record into every step.  All three fill to the same planes.

Every int32 value wraps as in XLA.  A u32 escape length of 2^31 - 3 or
more makes the match length wrap negative: the ``p + len > out_len`` check
passes and the position moves backwards with err clear, as in tpucomp.
"""

from __future__ import annotations

import torch

from .. import stats
from . import _build
from .common import SENT_KEY

MIN_MATCH = 3
COPY_BIT = 1 << 20
SENT = SENT_KEY
# the kernel's geometry (csrc/xp_parse.cu): a flag word and its 32 tokens
# span at least WORD_MIN bytes, so a row holds at most P // WORD_MIN + 1
# flag words, each with a 4-int entry state in scratch
WORD_MIN = 36
ENTRY = 4

# modes, as in tpucomp's codecs/xpress
_M_F3 = 3  # flag word bytes 0-3 are modes 0-3
_M_TOK, _M_HI, _M_NIB, _M_ESC = 4, 5, 6, 7
_M_U16_0, _M_U16_1 = 8, 9
_M_U32_0, _M_U32_1, _M_U32_2, _M_U32_3 = 10, 11, 12, 13


def _check(payload, plen, out_len, U):
    if payload.dtype != torch.uint8 or payload.dim() != 2:
        raise ValueError("payload must be a uint8 [N, P] tensor")
    N = payload.shape[0]
    for name, t in (("plen", plen), ("out_len", out_len)):
        if t.dtype != torch.int32 or tuple(t.shape) != (N,):
            raise ValueError(f"{name} must be an int32 [N] tensor")
    if U <= 0:
        raise ValueError("U must be positive")


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 -> its value mod 2^32 as a signed int32 (still int64)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def xp_parse_ref(payload: torch.Tensor, plen: torch.Tensor,
                 out_len: torch.Tensor, U: int):
    """Plain PyTorch version of :func:`xp_parse`: a Python loop over byte
    steps, vectorised over rows, like tpucomp's XLA scan.  The state is
    int64 holding int32 values, wrapped where XLA's int32 wraps."""
    _check(payload, plen, out_len, U)
    N, P = payload.shape
    dev = payload.device
    i64 = dict(dtype=torch.int64, device=dev)
    (p, mode, flags, nflags, pend_lo, pend_len, nib_have, nib_val,
     err) = (torch.zeros(N, **i64) for _ in range(9))
    plen = plen.long().clamp(max=P)
    olen = out_len.long()
    body = payload.long()
    pos_cols, val_cols = [], []
    steps = int(plen.max()) if N else 0
    for s in range(steps):
        active = (s < plen) & (p < olen)
        if not bool(active.any()):
            break
        b = body[:, s]
        is_f = active & (mode <= _M_F3)
        is_tok = active & (mode == _M_TOK)
        is_hi = active & (mode == _M_HI)
        is_nib = active & (mode == _M_NIB)
        is_esc = active & (mode == _M_ESC)
        is_u16a = active & (mode == _M_U16_0)
        is_u16b = active & (mode == _M_U16_1)
        is_u32nd = active & (mode >= _M_U32_0) & (mode < _M_U32_3)
        is_u32d = active & (mode == _M_U32_3)

        # flag word accumulation (LE bytes; consumed MSB first)
        flags = torch.where(is_f, _wrap(flags | (b << ((mode & 3) * 8))),
                            flags)
        f_done = active & (mode == _M_F3)
        nflags = torch.where(f_done, 32, nflags)
        bit = (flags >> 31) & 1
        is_lit = is_tok & (bit == 0)
        is_lo = is_tok & (bit == 1)

        # match high byte: offset and short length, maybe complete
        tok = pend_lo | (b << 8)
        L0 = tok & 7
        hi_short = is_hi & (L0 < 7)
        hi_esc = is_hi & (L0 == 7)
        use_stored = hi_esc & (nib_have == 1)
        stored_lt15 = use_stored & (nib_val < 15)
        stored_esc = use_stored & (nib_val == 15)
        need_nib = hi_esc & (nib_have == 0)

        nib_lo = b & 0xF
        nib_done = is_nib & (nib_lo < 15)
        nib_esc = is_nib & (nib_lo == 15)

        esc_done = is_esc & (b < 255)
        esc_u16 = is_esc & (b == 255)
        u16v = pend_len | (b << 8)
        u16_zero = is_u16b & (u16v == 0)
        u16_done = is_u16b & (u16v != 0)
        u32v = _wrap(pend_len | (b << 24))

        m_len = torch.where(
            hi_short, L0 + MIN_MATCH,
            torch.where(stored_lt15, nib_val + 7 + MIN_MATCH,
                        torch.where(nib_done, nib_lo + 7 + MIN_MATCH,
                                    torch.where(esc_done, b + 22 + MIN_MATCH,
                                                torch.where(
                                                    u16_done, u16v + MIN_MATCH,
                                                    _wrap(u32v + MIN_MATCH))))))
        m_done = (hi_short | stored_lt15 | nib_done | esc_done | u16_done
                  | is_u32d)
        err = err | (u16_done & (u16v < 22)).long() \
            | (is_u32d & (u32v < 22)).long()

        # shared nibble: the first use stores the byte's high half
        nib_have = torch.where(is_nib, 1, torch.where(use_stored, 0,
                                                      nib_have))
        nib_val = torch.where(is_nib, b >> 4, nib_val)

        # the pending offset survives the escape bytes (the high byte
        # stores the whole token)
        pend_lo = torch.where(is_lo, b, torch.where(is_hi, tok, pend_lo))
        m_off = (pend_lo >> 3) + 1
        pend_len = torch.where(
            is_u16a | (active & (mode == _M_U32_0)), b,
            torch.where(active & (mode == _M_U32_1), pend_len | (b << 8),
                        torch.where(active & (mode == _M_U32_2),
                                    pend_len | (b << 16), pend_len)))

        # records and the output position
        end = _wrap(p + m_len)
        err = err | (m_done & ((m_off > p) | (end > olen))).long()
        rec_new = is_lit | m_done
        pos_cols.append(torch.where(rec_new, p, SENT))
        val_cols.append(torch.where(is_lit, b, torch.where(
            m_done, COPY_BIT | m_off, 0)))
        p = torch.where(is_lit, p + 1, torch.where(m_done, end, p))
        p = p.clamp(max=U)

        # flag bit consumed on token completion
        flags = torch.where(rec_new, _wrap(flags << 1), flags)
        nflags = nflags - rec_new.long()

        mode2 = torch.where(
            is_f, torch.where(f_done, _M_TOK, mode + 1),
            torch.where(
                is_lit | m_done, _M_TOK,
                torch.where(
                    is_lo, _M_HI,
                    torch.where(
                        need_nib, _M_NIB,
                        torch.where(
                            stored_esc | nib_esc, _M_ESC,
                            torch.where(
                                esc_u16, _M_U16_0,
                                torch.where(
                                    is_u16a, _M_U16_1,
                                    torch.where(
                                        u16_zero, _M_U32_0,
                                        torch.where(is_u32nd, mode + 1,
                                                    mode)))))))))
        # a fresh flag word once the group's 32 tokens are done
        fresh = rec_new & (nflags == 0) & (mode2 == _M_TOK)
        mode = torch.where(fresh, 0, mode2)
        flags = torch.where(mode == 0, 0, flags)
    cols = len(pos_cols)
    rec_pos = torch.full((N, P), SENT, dtype=torch.int32, device=dev)
    rec_val = torch.zeros((N, P), dtype=torch.int32, device=dev)
    if cols:
        rec_pos[:, :cols] = torch.stack(pos_cols, 1)
        rec_val[:, :cols] = torch.stack(val_cols, 1)
    return rec_pos, rec_val, p.to(torch.int32), err.to(torch.int32)


def xp_parse(payload: torch.Tensor, plen: torch.Tensor,
             out_len: torch.Tensor, U: int):
    """Parse a batch of plain Xpress unit streams into token records.

    Args:
      payload: uint8 [N, P], each stream, zero-padded.
      plen:    int32 [N], stream length (clamped to P).
      out_len: int32 [N], the decoded length of each row; parsing stops
               there.
      U:       the clamp of the output position (the row width).

    Returns (rec_pos [N, P], rec_val [N, P], p_final [N], err [N]), all
    int32: see the module docstring.  ``err`` flags a match before the
    start or past ``out_len`` and an escape length below 22; a stream that
    ends early shows as ``p_final < out_len``.
    """
    if not _build.use_kernel(payload, plen, out_len):
        return xp_parse_ref(payload, plen, out_len, U)
    _check(payload, plen, out_len, U)
    payload, plen, out_len = (t.contiguous() for t in (payload, plen, out_len))
    N, P = payload.shape
    rec_pos = torch.empty((N, P), dtype=torch.int32, device=payload.device)
    rec_val = torch.empty_like(rec_pos)
    p_final = torch.empty_like(plen)
    err = torch.empty_like(plen)
    steps = torch.empty_like(plen)
    if N:
        max_words = P // WORD_MIN + 2
        entries = torch.empty((N, max_words, ENTRY), dtype=torch.int32,
                              device=payload.device)
        _build.launch("xp_parse",
                      [payload, plen, out_len, rec_pos, rec_val, p_final, err,
                       steps, entries], [N, P, U, max_words])
        stats.launched(xp_parse)
        xp_parse.steps = steps
    return rec_pos, rec_val, p_final, err


xp_parse.launches = 0
xp_parse.steps = None

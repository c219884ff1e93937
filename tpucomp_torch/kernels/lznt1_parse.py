"""LZNT1 decode parse: the flag/token byte machine, one chunk per row.

Counterpart of ``tpucomp/kernels/lznt1_pallas.py`` ``parse_records``
([MS-XCA] §2.5).  :func:`lznt1_parse` launches ``csrc/lznt1_parse.cu``
on CUDA tensors and runs :func:`lznt1_parse_ref` on CPU tensors.

Record contract (the same as tpucomp's for the first ``P`` columns): byte
step ``s`` that completes a token writes ``rec_pos[n, s]`` = the token's
output position and ``rec_val[n, s]`` = the literal byte or
``COPY_BIT | disp``.  Empty slots hold ``SENT`` and ``EMPTY_VAL``, the
value tpucomp's unpacking gives an empty slot.  Record positions strictly
increase along a row.
"""

from __future__ import annotations

import torch

from . import _build
from .common import SENT_KEY

U = 4096  # LZNT1 chunk: the output width of one row
MIN_MATCH = 3
SENT = SENT_KEY
COPY_BIT = 1 << 20
EMPTY_VAL = COPY_BIT | 0x3FFF

_M_FLAG, _M_TOK, _M_HI = 0, 1, 2


def _d_shift_table(device) -> torch.Tensor:
    """Copy-token displacement shift at output position p, for p in [0, U]:
    ``12 - max(bitlen(max(p - 1, 0)) - 4, 0)``."""
    return torch.tensor(
        [12 - max(max(p - 1, 0).bit_length() - 4, 0) for p in range(U + 1)],
        dtype=torch.int32, device=device)


def _check(payload, plen, is_comp):
    if payload.dtype != torch.uint8 or payload.dim() != 2:
        raise ValueError("payload must be a uint8 [N, P] tensor")
    N = payload.shape[0]
    if plen.dtype != torch.int32 or tuple(plen.shape) != (N,):
        raise ValueError("plen must be an int32 [N] tensor")
    if is_comp.dtype != torch.bool or tuple(is_comp.shape) != (N,):
        raise ValueError("is_comp must be a bool [N] tensor")


def lznt1_parse_ref(payload: torch.Tensor, plen: torch.Tensor,
                    is_comp: torch.Tensor):
    """Plain PyTorch version of :func:`lznt1_parse`: a Python loop over
    payload steps, vectorised over the chunks, like tpucomp's XLA scan."""
    _check(payload, plen, is_comp)
    N, P = payload.shape
    dev = payload.device
    i32 = dict(dtype=torch.int32, device=dev)
    d_shift_at = _d_shift_table(dev)
    body = payload.to(torch.int32)
    plen = plen.clamp(max=P)
    p, mode, flags, nflags, pend_lo, err = (
        torch.zeros(N, **i32) for _ in range(6))
    rec_pos = torch.full((N, P), SENT, **i32)
    rec_val = torch.full((N, P), EMPTY_VAL, **i32)
    # no chunk is active at or past its plen: stop at the longest
    steps = int(torch.where(is_comp, plen, 0).max()) if N else 0
    for s in range(steps):
        b = body[:, s]
        active = is_comp & (s < plen) & (p < U)
        is_flag = active & (mode == _M_FLAG)
        is_tok = active & (mode == _M_TOK)
        is_hi = active & (mode == _M_HI)
        flags = torch.where(is_flag, b, flags)
        nflags = torch.where(is_flag, 8, nflags)
        is_lit = is_tok & ((flags & 1) == 0)
        is_lo = is_tok & ((flags & 1) == 1)
        tok = pend_lo | (b << 8)
        d_shift = d_shift_at[p]
        length = (tok & ((1 << d_shift) - 1)) + MIN_MATCH
        disp = (tok >> d_shift) + 1
        err = err | (is_hi & ((disp > p) | (p + length > U))).int()
        rec_pos[:, s] = torch.where(is_lit | is_hi, p, SENT)
        rec_val[:, s] = torch.where(
            is_lit, b, torch.where(is_hi, COPY_BIT | disp, EMPTY_VAL))
        p = torch.minimum(p + is_lit.int() + is_hi.int() * length,
                          torch.tensor(U, **i32))
        pend_lo = torch.where(is_lo, b, pend_lo)
        # the flag bit is consumed when the token starts (literal or lo)
        took_bit = is_lit | is_lo
        flags = torch.where(took_bit, flags >> 1, flags)
        nflags = nflags - took_bit.int()
        next_tok = torch.where(nflags == 0, _M_FLAG, _M_TOK).int()
        mode = torch.where(
            is_flag, _M_TOK,
            torch.where(is_lit | is_hi, next_tok,
                        torch.where(is_lo, _M_HI, mode)))
    # a stream that ends after a copy token's lo byte is malformed
    err = err | (is_comp & (mode == _M_HI)).int()
    return rec_pos, rec_val, p, err


def lznt1_parse(payload: torch.Tensor, plen: torch.Tensor,
                is_comp: torch.Tensor):
    """Parse a batch of LZNT1 chunk payloads into token records.

    Args:
      payload: uint8 [N, P], the chunk bodies (headers stripped), zero-padded.
      plen:    int32 [N], payload length; must be <= P.
      is_comp: bool [N], the chunk header's compressed flag.

    Returns (rec_pos [N, P], rec_val [N, P], p_final [N], err [N]), all
    int32: see the module docstring; ``p_final`` is the decoded length of
    a compressed chunk and ``err`` flags a malformed one (disp > position,
    a copy past the chunk end, or a stream that ends mid-token).
    """
    if not _build.use_kernel(payload, plen, is_comp):
        return lznt1_parse_ref(payload, plen, is_comp)
    _check(payload, plen, is_comp)
    payload, plen, is_comp = (
        t.contiguous() for t in (payload, plen, is_comp))
    N, P = payload.shape
    rec_pos = torch.empty((N, P), dtype=torch.int32, device=payload.device)
    rec_val = torch.empty_like(rec_pos)
    p_final = torch.empty_like(plen)
    err = torch.empty_like(plen)
    if N:
        _build.launch("lznt1_parse",
                      [payload, plen, is_comp, rec_pos, rec_val, p_final, err],
                      [N, P])
        lznt1_parse.launches += 1
    return rec_pos, rec_val, p_final, err


lznt1_parse.launches = 0

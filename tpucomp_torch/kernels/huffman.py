"""Canonical Huffman tables of Xpress Huffman decode, in plain PyTorch.

Counterparts of ``tpucomp/kernels/huffman.py`` ``canonical_from_lengths``
and ``rank_to_symbol_table`` (XLA in tpucomp, so plain tensor code here),
of ``codecs/xpress_huff._unpack_table``, and of the table prep that
``xh_pallas.parse_records`` does before its kernel ([MS-XCA] §2.1.2).

A symbol's canonical rank is its place in (length, symbol) order.  Per
code length l (1..15), ``fc[l]`` is the first code of that length,
``br[l]`` the rank of its first symbol and ``lim[l] = fc[l] + cnt[l]``.
"""

from __future__ import annotations

import torch

MAX_CODE_LEN = 15
NUM_SYMBOLS = 512


def unpack_table(payload: torch.Tensor) -> torch.Tensor:
    """[N, P] stream bytes -> int32 [N, 512] code lengths from the 256-byte
    table prefix: symbol 2i has the low nibble of byte i, 2i + 1 the high."""
    tb = payload[:, :256].to(torch.int32)
    return torch.stack([tb & 0xF, (tb >> 4) & 0xF], dim=2).reshape(
        tb.shape[0], NUM_SYMBOLS)


def _rank_order(lengths: torch.Tensor) -> torch.Tensor:
    """Symbols in canonical rank order, [N, 512] int64.  The sort key
    ``len << 10 | sym`` is unique (unused symbols sort last, by symbol),
    so the order does not depend on the sort's stability."""
    sym = torch.arange(NUM_SYMBOLS, device=lengths.device)
    key = torch.where(lengths > 0, lengths.long(), MAX_CODE_LEN + 1) << 10 | sym
    return key.sort(dim=1).indices


def canonical_from_lengths(lengths: torch.Tensor):
    """(codes [N, 512], fc, br, lim [N, 16]), all int32, as tpucomp's
    ``canonical_from_lengths``: the code of every used symbol (0 for an
    unused one) and the per-level first code, base rank and limit."""
    N = lengths.shape[0]
    dev = lengths.device
    lvl = torch.arange(MAX_CODE_LEN + 1, device=dev)
    cnt = ((lengths[:, :, None] == lvl) & (lengths[:, :, None] > 0)).sum(
        dim=1).to(torch.int32)  # [N, 16]
    fc = torch.zeros((N, MAX_CODE_LEN + 1), dtype=torch.int32, device=dev)
    br = torch.zeros_like(fc)
    code = torch.zeros(N, dtype=torch.int32, device=dev)
    rank = torch.zeros_like(code)
    for l in range(1, MAX_CODE_LEN + 1):
        fc[:, l] = code
        br[:, l] = rank
        code = (code + cnt[:, l]) << 1
        rank = rank + cnt[:, l]
    lim = fc + cnt
    # a used symbol's code: fc[len] + (its rank - br[len])
    order = _rank_order(lengths)
    r = torch.empty_like(order)
    r.scatter_(1, order, torch.arange(NUM_SYMBOLS, device=dev).expand(N, -1))
    ln = lengths.long()
    codes = fc.gather(1, ln) + (r.to(torch.int32) - br.gather(1, ln))
    return torch.where(lengths > 0, codes, 0), fc, br, lim


def rank_to_symbol_table(lengths: torch.Tensor) -> torch.Tensor:
    """int32 [N, 512]: canonical rank -> symbol; ranks at or past the count
    of used symbols map to 0."""
    order = _rank_order(lengths).to(torch.int32)
    used = (lengths > 0).sum(dim=1, keepdim=True)
    rank = torch.arange(NUM_SYMBOLS, device=lengths.device)
    return torch.where(rank < used, order, 0)


def level_tables(fc: torch.Tensor, br: torch.Tensor, lim: torch.Tensor):
    """The parse's per-level tables (``xh_pallas.parse_records`` prep):
    ``LIM15[l] = lim[l] << (15 - l)``, the level's limit scaled to 15 bits,
    and ``rbf[l] = br[l] - fc[l]``, so that a code of level l read as its
    top l bits ``c`` has rank ``rbf[l] + c``.  Both int32 [N, 16]."""
    lvl = torch.arange(MAX_CODE_LEN + 1, dtype=torch.int32, device=fc.device)
    return lim << (MAX_CODE_LEN - lvl), br - fc

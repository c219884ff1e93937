"""Shared pieces of ``tpucomp.kernels.common`` that the port's codecs use.

``fill_records_delta``, ``place_monotone``, ``scatter_sorted_or`` and
``histogram_matmul`` are XLA in tpucomp, not Pallas, so they stay plain
PyTorch here (all but the first as direct scatters).  :func:`far_rounds`
is tpucomp's ``_far_rounds``: the far levels that resolve the tags the
near walk leaves, each a CUDA kernel of :mod:`tpucomp_torch.kernels.gather`.
"""

from __future__ import annotations

import torch

FAR_TAG = 1 << 24  # out-value tag: "pointer to earlier output position"
SENT_KEY = 1 << 28  # empty-record key (the parse's SENT)
# widest row of a block's parse: a block decodes to at most 64 KiB
MAX_ROW = 1 << 16
# widest row of the decode resolve (the near walk and the far levels): a
# one-shot XH row, [64 KiB of history | the 64 KiB block]; an absolute
# source must fit the far levels' 17-bit field
MAX_RESOLVE_ROW = 1 << 17

# tpucomp's _far_rounds levels (common.py:1472): one 4 KiB segment level,
# capped at 6 rounds, before the full-row level
SEG_LEVEL = 4096
SEG_LEVEL_CAP = 6
# value-chase probe rounds of the archive fast path (common.py:1283)
ARCHIVE_PROBE_BUDGET = 2


def level_cap(S: int) -> int:
    """Round cap of a doubling level over S-wide segments when none is
    given: ``bitlen(S - 1) + 3`` (common.py:1674); 15 at 4096, 19 at
    65536, 20 at 131072."""
    return max(1, (S - 1).bit_length()) + 3


def far_rounds(out: torch.Tensor, U: int, min_hop: int,
               fast: bool = False) -> torch.Tensor:
    """Resolve the far tags of the near walk's output, int32 [N, U], as
    tpucomp's ``_far_rounds(out, U, min_hop, fast)`` (``max_hop=None``).

    - The 4 KiB segment level runs when ``min_hop < 4096 < U`` and 4096
      divides U (common.py:1507-1510); its leftover tags stay.
    - ``fast``: then the value-chase probes, at most
      ``ARCHIVE_PROBE_BUDGET`` rounds (common.py:1511-1529).
    - Then the full-row level; the tags it leaves are zeroed.

    LZNT1 (U = 4096) runs the full-row level alone; the one-shot XH
    decode's ``[history | block]`` rows (U = 131072) run both levels.
    Returns bytes, int32 [N, U].
    """
    # deferred: gather imports this module's constants
    from .gather import MAX_SEG, far_level, far_probe, far_row

    if min_hop < SEG_LEVEL < U and U % SEG_LEVEL == 0:
        out = far_level(out, SEG_LEVEL, SEG_LEVEL_CAP, zero=False)
    if fast:
        out = far_probe(out, ARCHIVE_PROBE_BUDGET)
    if U <= MAX_SEG:
        return far_level(out)
    return far_row(out)


def rolled_or(planes) -> torch.Tensor:
    """planes[k] moved k columns right (the last k wrap to the front, as
    tpucomp's ``jnp.roll``), all ORed: a byte sequence anchored at each
    entry's key, from one placed plane per byte."""
    acc = planes[0]
    for k in range(1, len(planes)):
        acc = acc | planes[k].roll(k, 1)
    return acc


def place_monotone(empty: torch.Tensor, keys: torch.Tensor, vals,
                   U: int):
    """Dense placement of sorted records: ``out[n, k]`` = the value of the
    entry whose key is k, 0 where there is none.  Keys strictly increase
    along a row among the entries that are not ``empty``; keys outside
    [0, U) count as empty.  ``vals`` is a tensor or a tuple of tensors
    shaped as ``keys``.

    tpucomp's ``place_monotone`` reaches this with log-depth compaction
    and expansion passes because the TPU has no scatter; here it is one
    scatter per plane, into a spare column U for the empty entries.
    """
    single = not isinstance(vals, (tuple, list))
    vs = (vals,) if single else tuple(vals)
    N = keys.shape[0]
    real = ~empty & (keys >= 0) & (keys < U)
    target = torch.where(real, keys, U).long()
    out = []
    for v in vs:
        o = torch.zeros((N, U + 1), dtype=v.dtype, device=v.device)
        o.scatter_(1, target, torch.where(real, v, 0))
        out.append(o[:, :U])
    return out[0] if single else tuple(out)


def scatter_sorted_or(keys: torch.Tensor, vals: torch.Tensor,
                      U: int) -> torch.Tensor:
    """``out[n, u]`` = the OR of ``vals`` over the entries whose key is u,
    0 where there is none; keys outside [0, U) are dropped.

    The values of one key must share no bit (zero placeholders are
    harmless), as the encoders' group flag bits do: then the OR is the
    sum, and one ``scatter_add_`` computes it.  tpucomp's form is a
    segmented scan plus :func:`place_monotone` over non-decreasing keys.
    """
    N = keys.shape[0]
    real = (keys >= 0) & (keys < U)
    out = torch.zeros((N, U + 1), dtype=vals.dtype, device=vals.device)
    out.scatter_add_(1, torch.where(real, keys, U).long(),
                     torch.where(real, vals, 0))
    return out[:, :U]


def histogram(sym: torch.Tensor, nbins: int) -> torch.Tensor:
    """Per-row counts, int32 [N, nbins]: ``out[n, s]`` = how many
    ``sym[n, i] == s``, for s < nbins; symbols outside [0, nbins) (the XH
    encoder's sentinel 512) are dropped.  tpucomp's ``histogram_matmul``
    counts with one-hot matmuls; here it is one ``scatter_add_`` into a
    spare column for the dropped symbols."""
    N = sym.shape[0]
    real = (sym >= 0) & (sym < nbins)
    out = torch.zeros((N, nbins + 1), dtype=torch.int32, device=sym.device)
    out.scatter_add_(1, torch.where(real, sym, nbins).long(),
                     torch.ones_like(sym, dtype=torch.int32))
    return out[:, :nbins]


def fill_records_delta(rec_pos: torch.Tensor, rec_val: torch.Tensor,
                       U: int) -> torch.Tensor:
    """Dense fill: out[n, j] = value (mod 2^22) of the last record with
    pos <= j, 0 if none, for every j in [0, U).

    Records with pos outside [0, U) are empty.  Real record positions must
    be non-decreasing along a row; among equal adjacent positions the last
    wins.  Same contract as tpucomp's ``fill_records_delta``, computed as a
    scatter of slot indices plus a running max along the row.
    """
    N, R = rec_pos.shape
    real = (rec_pos >= 0) & (rec_pos < U)
    slot = torch.arange(R, device=rec_pos.device).expand(N, R)
    # empty records scatter into a spare column U, sliced off below
    target = torch.where(real, rec_pos, U).long()
    last = torch.full((N, U + 1), -1, dtype=torch.long, device=rec_pos.device)
    last.scatter_reduce_(1, target, torch.where(real, slot, -1), "amax")
    last = last[:, :U].cummax(dim=1).values
    val = rec_val.gather(1, last.clamp(min=0))
    return torch.where(last >= 0, val & ((1 << 22) - 1), 0).to(torch.int32)

"""Row gathers: the generic one, and the far levels of copy resolution
(pointer doubling, value-chase probes).

- :func:`gather_rows`: ``out[n, q] = data[n, idx[n, q]]``, tpucomp's
  ``mxu_gather_rows`` and its Pallas form ``gather_rows_fused``.
  Launches ``csrc/gather_rows.cu``, one thread a query.

After the near walk, a position holds a byte or ``FAR_TAG | src``, an
absolute source in its row.  Counterparts of tpucomp's round loops and
the Pallas gathers they drive (``tpucomp/kernels/common.py``,
``gather_pallas.py``):

- :func:`far_level`: ``_far_level_segmented(out, U, S, cap)`` for
  segments of S <= 4096 bytes, the fetch ``gather18_stacked``.  Launches
  ``csrc/far_level.cu``, one block per segment.
- :func:`far_row`: the full-row level ``_far_level_segmented(out, U, U)``
  of rows wider than 4096 bytes, the fetch ``gather18_pairs``.  Launches
  ``csrc/far_row.cu``, one block per row: a sweep over the row's chunks
  of 1024 positions from left to right, each tag taking its source's
  final value, for rows whose live tags point no further than their own
  chunk's end (every real row); the level's rounds for the others.
- :func:`far_probe`: the value-chase rounds of ``_far_rounds(fast=True)``
  (``_far_probe_round``), the fetch ``probe_gather_pairs``.  Launches
  ``csrc/far_probe.cu``: one pass, each tag following at most ``rounds``
  hops through the input plane, blocks of 1024 positions.

Each runs its plain PyTorch version (``*_ref``) on CPU tensors.

Doubling state per position, 18 bits: a resolved byte, or ``(1 << 17) |
src``.  A round sets ``st[j] = st[src]`` wherever a tag is live and its
source lies in the segment; a fetched tag is the target's own pointer, so
every chain halves per round.  A fetched tag whose source lies outside
the segment is adopted: it stays, and the next level chases it.
"""

from __future__ import annotations

import torch

from .. import stats
from . import _build
from .common import ARCHIVE_PROBE_BUDGET, FAR_TAG, MAX_RESOLVE_ROW, level_cap

MAX_SEG = 4096  # a segment's double-buffered state fits shared memory


def plane_mask(nbits: int) -> int:
    """The bits a gather of ``nbits``-bit values keeps: tpucomp assembles
    ``min(4, ceil(nbits / 8))`` whole byte planes (``gather_pallas.py:348``,
    ``common.py:899``), so ``nbits = 20`` keeps 24 bits; -1 for all 32."""
    if nbits < 1:
        raise ValueError(f"nbits must be at least 1, got {nbits}")
    planes = min(4, -(-nbits // 8))
    return -1 if planes == 4 else (1 << (8 * planes)) - 1


def _check_gather(data, idx):
    if data.dtype != torch.int32 or idx.dtype != torch.int32 \
            or data.dim() != 2 or idx.dim() != 2 \
            or data.shape[0] != idx.shape[0]:
        raise ValueError("gather_rows takes int32 [N, K] data and int32 "
                         "[N, Q] indices")


def gather_rows_ref(data: torch.Tensor, idx: torch.Tensor,
                    nbits: int = 32) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather_rows`: one
    ``torch.gather``."""
    _check_gather(data, idx)
    mask = plane_mask(nbits)
    if data.shape[1] == 0:
        return torch.zeros_like(idx)
    ok = (idx >= 0) & (idx < data.shape[1])
    got = data.gather(1, torch.where(ok, idx, 0).long())
    return torch.where(ok, got & mask, 0)


def gather_rows(data: torch.Tensor, idx: torch.Tensor,
                nbits: int = 32) -> torch.Tensor:
    """``out[n, q] = data[n, idx[n, q]]`` masked to :func:`plane_mask`
    ``(nbits)``; an index outside [0, K) reads 0.  Takes int32 [N, K] and
    int32 [N, Q], returns int32 [N, Q]; bit 31 passes when ``nbits`` >=
    25."""
    if not _build.use_kernel(data, idx):
        return gather_rows_ref(data, idx, nbits)
    _check_gather(data, idx)
    mask = plane_mask(nbits)
    N, K = data.shape
    Q = idx.shape[1]
    src, ix = data.contiguous(), idx.contiguous()
    out = torch.empty_like(ix)
    if N and Q:
        _build.launch("gather_rows", [src, ix, out], [N, K, Q, mask])
        stats.launched(gather_rows)
    return out


gather_rows.launches = 0


def gather18_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[n, q] = table[n, idx[n, q]] & 0x3FFFF (18-bit values); an index
    outside [0, K) reads 0, as in ``gather_pallas.gather18_stacked``."""
    ok = (idx >= 0) & (idx < table.shape[1])
    got = table.gather(1, torch.where(ok, idx, 0).long())
    return torch.where(ok, got & 0x3FFFF, 0)


def _check(out, S):
    if out.dtype != torch.int32 or out.dim() != 2:
        raise ValueError("the far levels take an int32 [N, U] tensor")
    U = out.shape[1]
    if not 0 < U <= MAX_RESOLVE_ROW or U % S:
        raise ValueError(f"rows must be at most {MAX_RESOLVE_ROW} wide and "
                         f"cut into whole segments of {S}, got {U}")


def far_level_ref(out: torch.Tensor, S=None, cap=None,
                  zero: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`far_level`: a ``torch.gather`` round
    loop over all segments, stopped when no segment has a live local tag,
    as tpucomp's ``while_loop`` is."""
    N, U = out.shape
    S = S or U
    _check(out, S)
    cap = cap or level_cap(S)
    nseg = U // S
    st = out.reshape(N * nseg, S)
    tagged = (st & FAR_TAG) != 0
    st = torch.where(tagged, (1 << 17) | (st & (FAR_TAG - 1)), st & 0x1FF)
    base = (torch.arange(N * nseg, dtype=torch.int32, device=out.device)
            % nseg * S)[:, None]
    for _ in range(cap):
        srcp = st & 0x1FFFF
        chase = ((st >> 17) == 1) & (srcp >= base) & (srcp < base + S)
        if not bool(chase.any()):
            break
        st = torch.where(chase, gather18_ref(st, torch.where(
            chase, srcp - base, 0)), st)
    res = torch.where((st >> 17) == 1, FAR_TAG | (st & 0x1FFFF), st & 0x1FF)
    if zero:
        # tags left after the round cap (only corrupt, cyclic streams): zero
        res = torch.where((res & FAR_TAG) != 0, 0, res)
    return res.reshape(N, U)


def far_level(out: torch.Tensor, S=None, cap=None,
              zero: bool = True) -> torch.Tensor:
    """One doubling level over segments of S bytes (default: the row).

    Takes and returns int32 [N, U], U a multiple of S and S <= 4096.
    ``cap`` bounds the rounds (default ``level_cap(S)``).  The result holds
    bytes and, for chains the level did not finish, ``FAR_TAG | src``;
    with ``zero`` those become 0, as after tpucomp's last level.
    """
    if not _build.use_kernel(out):
        return far_level_ref(out, S, cap, zero)
    N, U = out.shape
    S = S or U
    _check(out, S)
    if S > MAX_SEG:
        raise ValueError(f"segments wider than {MAX_SEG} take far_row")
    src = out.contiguous()
    res = torch.empty_like(src)
    if N:
        _build.launch("far_level", [src, res],
                      [N * (U // S), S, U // S, cap or level_cap(S),
                       int(zero)])
        stats.launched(far_level)
    return res


far_level.launches = 0


def far_row_ref(out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`far_row`: the full-row level of
    :func:`far_level_ref`, leftover tags zeroed."""
    return far_level_ref(out, None, None, zero=True)


def far_row(out: torch.Tensor) -> torch.Tensor:
    """The last doubling level, over whole rows of any width up to 131072:
    at most ``level_cap(U)`` rounds (19 at U = 65536, 20 at 131072), then
    the tags left are zeroed.  Takes and returns int32 [N, U].

    The rounds follow every chain to its end (a byte; 0 for a dead tag or
    a cycle), so the kernel sweeps a row's chunks of 1024 positions in
    order instead: a tag whose source lies in an earlier chunk takes the
    source's final value, tags inside the chunk resolve by pointer
    doubling.  A row with a live tag pointing past its own chunk's end,
    or a tag with state bits above 17, runs the rounds instead.
    ``far_row.looped`` (int32 [N] on the card) is 1 for the rows of the
    last launch that ran the rounds.
    """
    if not _build.use_kernel(out):
        return far_row_ref(out)
    N, U = out.shape
    _check(out, U)
    src = out.contiguous()
    res = torch.empty_like(src)
    looped = torch.empty(N, dtype=torch.int32, device=src.device)
    if N:
        # the rounds' state ping-pongs between res and this scratch
        scratch = torch.empty_like(src)
        _build.launch("far_row", [src, res, scratch, looped],
                      [N, U, level_cap(U)])
        stats.launched(far_row)
    far_row.looped = looped
    return res


far_row.launches = 0


def far_probe_ref(out: torch.Tensor,
                  rounds: int = ARCHIVE_PROBE_BUDGET) -> torch.Tensor:
    """Plain PyTorch version of :func:`far_probe`: tpucomp's round loop,
    stopped when no row changed or no tag is left."""
    _check(out, out.shape[1])
    U = out.shape[1]
    for _ in range(rounds):
        tagged = (out & FAR_TAG) != 0
        if not bool(tagged.any()):
            break
        probe = torch.where(tagged, 256, out & 0xFF)
        src = torch.where(tagged, out & (FAR_TAG - 1), 0)
        ok = src < U
        fetched = torch.where(ok, probe.gather(1, torch.where(ok, src, 0)
                                               .long()), 0)
        nxt = torch.where(tagged & (fetched < 256), fetched, out)
        if torch.equal(nxt, out):
            break
        out = nxt
    return out


def far_probe(out: torch.Tensor,
              rounds: int = ARCHIVE_PROBE_BUDGET) -> torch.Tensor:
    """Value-chase probes, the archive fast path: up to ``rounds`` rounds
    of ``out[j] = byte of out[src]`` for every tag whose source is already
    a byte (a source outside the row reads 0); a tag whose source is still
    tagged stays.  Takes and returns int32 [N, U] in the near walk's
    encoding (bytes, ``FAR_TAG | src``).

    The rounds are synchronous, so a tag ends as a byte exactly when its
    chain through the input reaches a byte (or a source past the row)
    within ``rounds`` hops: the kernel follows each chain that far in one
    pass and writes every position once; ``rounds`` <= 0 copies."""
    if not _build.use_kernel(out):
        return far_probe_ref(out, rounds)
    _check(out, out.shape[1])
    N, U = out.shape
    src = out.contiguous()
    res = torch.empty_like(src)
    if N:
        _build.launch("far_probe", [src, res], [N, U, rounds])
        stats.launched(far_probe)
    return res


far_probe.launches = 0

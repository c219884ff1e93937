"""Records -> dense per-byte planes: the fill of every decode path.

Counterpart of ``tpucomp/kernels/fill_pallas.py``
``fill_records_delta2_fused`` and of the contract it shares with
``common.fill_records_delta2``, for any record count R (tpucomp's fused
kernel takes R <= U only and leaves wider streams to XLA).
:func:`fill_records_delta2` (XH and plain Xpress: both planes and the
overflow flag) and :func:`fill_records_delta` (LZNT1: the value plane
alone, tpucomp's ``common.fill_records_delta``) launch
``csrc/fill_records.cu`` on CUDA tensors and run
:func:`fill_records_delta2_ref` / :func:`fill_records_delta_ref` on CPU
tensors.

The contract, per row and output byte j in [0, U):
  - a record with ``0 <= pos < U`` is real; any other is empty;
  - real positions do not decrease along the row, and among adjacent
    records at one position the last wins;
  - ``val[j]`` is the value mod 2^22 of the last real record with
    ``pos <= j``, and ``pos[j]`` that record's position mod 2^17 (the
    token start the periodic fold needs); both 0 where there is none;
  - ``ovf[n]`` is 1 when the row has more than ``keep`` distinct real
    records (the last of each adjacent run counts).
tpucomp's XLA form drops the records past ``keep``, its fused kernel
fills them; an overflowing row is an err row, whose bytes are
don't-care, and this port fills them as the fused kernel does.

The kernel cuts a row's R slots into ``T`` tiles of ``TS`` slots, one
block of ``threads`` a tile (:func:`tiles`); when ``T > 1`` a first pass
writes each tile's least real position and distinct count into a small
``[N, T, 2]`` summary, which the fill reads for the tile edges.
"""

from __future__ import annotations

import torch

from .. import stats
from . import _build
from .common import fill_records_delta as fill_records_delta_ref

V_RING = 1 << 22
P_RING = 1 << 17

# the kernel's geometry: csrc/fill_records.cu
PER_THREAD = 16  # consecutive record slots a thread
THREADS = 512  # most threads a block
TILE_SLOTS = PER_THREAD * THREADS  # most record slots a tile


def tiles(R: int, tile_slots: int = TILE_SLOTS, per: int = PER_THREAD):
    """(T, TS, threads): a row of R record slots cut into T tiles of TS
    slots (the last one shorter), TS a multiple of ``per``, one block of
    ``threads`` (a multiple of 32) a tile, ``per`` slots a thread.  The
    kernel's own geometry at the defaults; the tests' model takes
    narrower tiles."""
    T = max(1, -(-R // tile_slots))
    TS = max(per, -(-(-(-R // T)) // per) * per)
    threads = max(32, -(-(TS // per) // 32) * 32)
    return T, TS, threads


def _check(rec_pos, rec_val, U, keep):
    if rec_pos.dtype != torch.int32 or rec_pos.dim() != 2:
        raise ValueError("rec_pos must be an int32 [N, R] tensor")
    if rec_val.dtype != torch.int32 or rec_val.shape != rec_pos.shape:
        raise ValueError("rec_val must be an int32 tensor shaped as rec_pos")
    if U <= 0 or keep < 0:
        raise ValueError("U must be positive and keep non-negative")


def _keep(rec_pos, U, keep):
    return min(rec_pos.shape[1], U) if keep is None else keep


def fill_records_delta2_ref(rec_pos: torch.Tensor, rec_val: torch.Tensor,
                            U: int, keep=None):
    """Plain PyTorch version of :func:`fill_records_delta2`: an "amax"
    scatter of slot indices into positions, a running max along the row,
    and a gather of both planes."""
    keep = _keep(rec_pos, U, keep)
    _check(rec_pos, rec_val, U, keep)
    N, R = rec_pos.shape
    real = (rec_pos >= 0) & (rec_pos < U)
    slot = torch.arange(R, device=rec_pos.device).expand(N, R)
    # empty records scatter into a spare column U, sliced off below
    last = torch.full((N, U + 1), -1, dtype=torch.long, device=rec_pos.device)
    last.scatter_reduce_(1, torch.where(real, rec_pos, U).long(),
                         torch.where(real, slot, -1), "amax")
    last = last[:, :U].cummax(dim=1).values
    bound = last >= 0
    at = last.clamp(min=0)
    val = torch.where(bound, rec_val.gather(1, at) & (V_RING - 1), 0)
    pos = torch.where(bound, rec_pos.gather(1, at) & (P_RING - 1), 0)
    nxt_same = torch.zeros_like(real)
    nxt_same[:, :-1] = real[:, 1:] & (rec_pos[:, 1:] == rec_pos[:, :-1])
    ovf = ((real & ~nxt_same).sum(dim=1) > keep).to(torch.int32)
    return val.to(torch.int32), pos.to(torch.int32), ovf


def fill_records_delta2(rec_pos: torch.Tensor, rec_val: torch.Tensor,
                        U: int, keep=None):
    """Fill a row of U bytes from each row of token records.

    Args:
      rec_pos, rec_val: int32 [N, R], record positions and values.
      U:    the output width.
      keep: the most distinct real records a row may have; default
            min(R, U), which no row can pass.

    Returns (val [N, U], pos [N, U], ovf [N]), all int32: see the module
    docstring.
    """
    if not _build.use_kernel(rec_pos, rec_val):
        return fill_records_delta2_ref(rec_pos, rec_val, U, keep)
    keep = _keep(rec_pos, U, keep)
    _check(rec_pos, rec_val, U, keep)
    rec_pos, rec_val = rec_pos.contiguous(), rec_val.contiguous()
    N, R = rec_pos.shape
    val = torch.empty((N, U), dtype=torch.int32, device=rec_pos.device)
    pos = torch.empty_like(val)
    ovf = torch.empty((N,), dtype=torch.int32, device=rec_pos.device)
    if N:
        T, TS, threads = tiles(R)
        _build.launch("fill_records",
                      [rec_pos, rec_val, _summary(N, T, rec_pos), val, pos,
                       ovf],
                      [N, R, U, min(keep, 1 << 30), T, TS, threads,
                       _vec_in(rec_pos, rec_val), int(U % 4 == 0)])
        stats.launched(fill_records_delta2)
    return val, pos, ovf


fill_records_delta2.launches = 0


def fill_records_delta(rec_pos: torch.Tensor, rec_val: torch.Tensor,
                       U: int) -> torch.Tensor:
    """The value plane of :func:`fill_records_delta2` alone: int32 [N, U],
    the value mod 2^22 of the last real record with ``pos <= j``, 0 where
    there is none.  LZNT1's fill."""
    if not _build.use_kernel(rec_pos, rec_val):
        return fill_records_delta_ref(rec_pos, rec_val, U)
    _check(rec_pos, rec_val, U, 0)
    rec_pos, rec_val = rec_pos.contiguous(), rec_val.contiguous()
    N, R = rec_pos.shape
    val = torch.empty((N, U), dtype=torch.int32, device=rec_pos.device)
    if N:
        T, TS, threads = tiles(R)
        _build.launch("fill_records_value",
                      [rec_pos, rec_val, _summary(N, T, rec_pos), val],
                      [N, R, U, T, TS, threads, _vec_in(rec_pos, rec_val),
                       int(U % 4 == 0)])
        stats.launched(fill_records_delta)
    return val


fill_records_delta.launches = 0


def _summary(N, T, like):
    """The first pass's [N, T, 2] (min, count) pairs; unused when T == 1."""
    return torch.empty((N, T if T > 1 else 0, 2), dtype=torch.int32,
                       device=like.device)


def _vec_in(*planes):
    """1 when every row of the record planes starts on 16 bytes."""
    return int(all(p.shape[1] % 4 == 0 and p.data_ptr() % 16 == 0
                   for p in planes))

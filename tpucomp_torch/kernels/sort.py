"""Row sort by a unique int32 key, payload planes permuted along.

Counterpart of ``tpucomp/kernels/sort_pallas.py`` ``bitonic_sort_rows``,
and of ``tpucomp.kernels.common.sort_rows`` (``lax.sort`` with one key)
wherever the keys of a row are unique, as every caller's are: then the
order is the same whatever the sort.  :func:`sort_rows` launches
``csrc/sort_rows.cu`` on CUDA tensors and runs :func:`sort_rows_ref` on
CPU tensors.  The kernel is a radix sort: digit passes over the bits that
vary in a row (:func:`digit_passes`).  Rows up to 8192 sort in one
block's shared memory, with digits of up to 9 bits; wider rows (up to
131072: the stream encoder's 73,728) go through device memory in tiles of
``TILE``, with digits of up to 8 bits, two ping-pong (key, column) planes of [N, U] and each tile's
digit counts as scratch.
"""

from __future__ import annotations

import torch

from .. import stats
from . import _build

SMEM_ROW = 1 << 13  # the widest row sorted in one block's shared memory
TILE = 1 << 11  # (key, column) pairs of a tile in the tiled form
MAX_ROW = 1 << 17  # the widest row the tiled form takes
PLANES_PER_LAUNCH = 16  # payload planes one launch takes (kernel argument)
BLOCK_DIGIT_BITS = 9  # the widest digit of a row in one block
TILE_DIGIT_BITS = 8  # the widest digit of a tiled row


def _check(ops):
    if not ops:
        raise ValueError("sort_rows needs at least the key plane")
    key = ops[0]
    if key.dim() != 2:
        raise ValueError("planes must be [N, U] tensors")
    for t in ops:
        if t.dtype != torch.int32 or t.shape != key.shape:
            raise ValueError("planes must be int32 tensors of one shape")


def sort_rows_ref(operands) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`sort_rows`: ``torch.sort`` of the
    key, then ``torch.gather`` of every payload plane."""
    ops = tuple(operands)
    _check(ops)
    skey, idx = torch.sort(ops[0], dim=1)
    return (skey, *(p.gather(1, idx) for p in ops[1:]))


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bit length of every element of an int64 tensor in [0, 2^33)."""
    return sum(((v >> b) > 0).long() for b in range(34))


def digit_passes(key: torch.Tensor) -> torch.Tensor:
    """The digit passes the kernel runs on each row of an int32 key plane
    [N, U]: as few as digits of ``BLOCK_DIGIT_BITS`` bits or fewer (U up
    to ``SMEM_ROW``; else ``TILE_DIGIT_BITS``) take to cover the lowest to
    the highest bit in which some key of the row differs from its first (0
    for a row of one key).  Plain torch, for reports and tests."""
    d = (key.long() ^ key[:, :1].long()) & 0xFFFFFFFF
    low = torch.where(d == 0, 1 << 32, d & -d).amin(dim=1)
    high = d.amax(dim=1)
    nbits = torch.where(high == 0, 0, _bit_length(high) - _bit_length(low) + 1)
    most = BLOCK_DIGIT_BITS if key.shape[1] <= SMEM_ROW else TILE_DIGIT_BITS
    return (nbits + most - 1) // most


def sort_rows(operands) -> tuple[torch.Tensor, ...]:
    """Sort each row ascending by ``operands[0]`` and permute the other
    planes with it.

    Every plane is int32 [N, U] and contiguous; the keys of a row must be
    unique (the order of equal keys is unspecified).  On the card U is at
    most 131072.  Returns the sorted key plane and the permuted payload
    planes, in the order given.
    """
    ops = tuple(operands)
    if not _build.use_kernel(*ops):
        return sort_rows_ref(ops)
    _check(ops)
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("planes must be contiguous")
    N, U = ops[0].shape
    if U > MAX_ROW:
        raise ValueError(f"rows must be at most {MAX_ROW} wide, got {U}")
    outs = tuple(torch.empty_like(t) for t in ops)
    if N == 0 or U == 0:
        return outs
    if U <= SMEM_ROW:
        name, scratch, tile = "sort_rows", [], []
    else:
        name, tile = "sort_rows_tiled", [TILE]
        shapes = ((4, N, U), (N, -(-U // TILE), 1 << TILE_DIGIT_BITS), (N,))
        scratch = [torch.empty(shape, dtype=torch.int32, device=ops[0].device)
                   for shape in shapes]
    pay_in, pay_out = ops[1:], outs[1:]
    for k in range(0, max(1, len(pay_in)), PLANES_PER_LAUNCH):
        # each launch sorts the key again and writes it: planes past the
        # first launch's are rare (no caller has more than 8)
        group = slice(k, k + PLANES_PER_LAUNCH)
        _build.launch(name, [ops[0], outs[0], *scratch],
                      [N, U, len(pay_in[group]), *tile],
                      tables=(pay_in[group], pay_out[group]))
        stats.launched(sort_rows)
    return outs


sort_rows.launches = 0

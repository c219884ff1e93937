"""Row sort by a unique int32 key, payload planes permuted along.

Counterpart of ``tpucomp/kernels/sort_pallas.py`` ``bitonic_sort_rows``,
and of ``tpucomp.kernels.common.sort_rows`` (``lax.sort`` with one key)
wherever the keys of a row are unique, as every caller's are: then the
order is the same whatever the sort.  :func:`sort_rows` launches
``csrc/sort_rows.cu`` on CUDA tensors and runs :func:`sort_rows_ref` on
CPU tensors.  Rows of a power of two up to 16384 sort in one block's
shared memory; wider rows (up to 65536) and other widths sort in tiles
of 16384 with the wide strides over device memory (two int32 [N, Up]
scratch planes, Up the power of two at or above the width).
"""

from __future__ import annotations

import torch

from . import _build

SMEM_ROW = 1 << 14  # (key, column) pairs of a row in shared memory: 128 KiB
MAX_ROW = 1 << 16  # the widest row the tiled form takes
PLANES_PER_LAUNCH = 16  # payload planes one launch takes (kernel argument)


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


def sort_rows(operands) -> tuple[torch.Tensor, ...]:
    """Sort each row ascending by ``operands[0]`` and permute the other
    planes with it.

    Every plane is int32 [N, U] and contiguous; the keys of a row must be
    unique (the order of equal keys is unspecified).  On the card U is at
    most 65536.  Returns the sorted key plane and the permuted payload
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
    if U & (U - 1) == 0 and U <= SMEM_ROW:
        name, scratch = "sort_rows", []
    else:
        Up = 1 << (U - 1).bit_length()
        name = "sort_rows_tiled"
        scratch = [torch.empty((N, Up), dtype=torch.int32,
                               device=ops[0].device) for _ in range(2)]
    pay_in, pay_out = ops[1:], outs[1:]
    for k in range(0, max(1, len(pay_in)), PLANES_PER_LAUNCH):
        # each launch sorts the key again and writes it: planes past the
        # first launch's are rare (no caller has more than 8)
        group = slice(k, k + PLANES_PER_LAUNCH)
        _build.launch(name, [ops[0], outs[0], *scratch],
                      [N, U, len(pay_in[group])],
                      tables=(pay_in[group], pay_out[group]))
        sort_rows.launches += 1
    return outs


sort_rows.launches = 0

"""Exact match lengths for fixed small displacements (the run matcher).

Counterpart of ``tpucomp/kernels/runs_pallas.py`` ``run_matchlens_fused``
and of the XLA form ``tpucomp.kernels.common.run_matchlens``: for each d
in ``disps``, ``ml_d[n, p]`` is the length of the run of
``x[n, q] == x[n, q - d]`` that starts at q = p (0 where p < d).  Runs
reach into whatever the row holds past a chunk's end (its zero padding),
as tpucomp's do; the encoder clips them later.
:func:`run_matchlens` launches ``csrc/run_matchlens.cu`` on CUDA tensors
(a block a tile of ``TILE`` positions, every displacement of the launch
from one load of the bytes; rows of several tiles first get each tile's
first break from a small first kernel of the same launch) and runs
:func:`run_matchlens_ref` on CPU tensors.
"""

from __future__ import annotations

import torch

from .. import stats
from . import _build

# the encoders' widest row, the stream encoder's [8 KiB history | 64 KiB
# lane] of 73,728 within it (the kernel's tiles take any width)
MAX_ROW = 1 << 17
DISPS_PER_LAUNCH = 4  # displacements one launch takes (C int arguments)
TILE = 4096  # positions a block of the kernel takes


def _check(x, disps):
    if x.dtype != torch.uint8 or x.dim() != 2:
        raise ValueError("x must be a uint8 [N, U] tensor")
    if any(d < 1 for d in disps):
        raise ValueError(f"displacements must be positive, got {disps}")


def run_matchlens_ref(x: torch.Tensor, disps) -> list[torch.Tensor]:
    """Plain PyTorch version of :func:`run_matchlens`: the first q >= p
    with ``x[q] != x[q - d]`` by a suffix minimum (``cummin`` on the
    flipped row); the run length is its distance from p."""
    disps = tuple(int(d) for d in disps)
    _check(x, disps)
    N, U = x.shape
    pos = torch.arange(U, dtype=torch.int32, device=x.device)
    outs = []
    for d in disps:
        eq = torch.zeros((N, U), dtype=torch.bool, device=x.device)
        if d < U:
            eq[:, d:] = x[:, d:] == x[:, :-d]
        stop = torch.where(eq, U, pos)  # U: no break up to the row end
        nxt = stop.flip(1).cummin(dim=1).values.flip(1)
        outs.append((nxt - pos).to(torch.int32))
    return outs


def run_matchlens(x: torch.Tensor, disps) -> list[torch.Tensor]:
    """Run lengths of ``x`` (uint8 [N, U], contiguous, U <= 131072) against
    itself shifted by each d in ``disps``.  Returns one int32 [N, U]
    tensor per displacement, in the order given."""
    disps = tuple(int(d) for d in disps)
    if not _build.use_kernel(x):
        return run_matchlens_ref(x, disps)
    _check(x, disps)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    N, U = x.shape
    if U > MAX_ROW:
        raise ValueError(f"rows of at most {MAX_ROW} bytes, got {U}")
    out = torch.empty((len(disps), N, U), dtype=torch.int32, device=x.device)
    if N and U:
        # each (row, tile)'s first break per displacement, written by the
        # launch's first kernel when a row has several tiles
        first = torch.empty((N, -(-U // TILE), DISPS_PER_LAUNCH),
                            dtype=torch.int32, device=x.device)
        for k in range(0, len(disps), DISPS_PER_LAUNCH):
            ds = disps[k:k + DISPS_PER_LAUNCH]
            ds += (0,) * (DISPS_PER_LAUNCH - len(ds))
            _build.launch("run_matchlens", [x, first, out[k]],
                          [N, U, min(DISPS_PER_LAUNCH, len(disps) - k), *ds])
            stats.launched(run_matchlens)
    return list(out.unbind(0))


run_matchlens.launches = 0

"""Near-window copy resolution over 512-byte segments.

Counterpart of ``tpucomp/kernels/resolve_pallas.py`` ``resolve_copies``
up to, not including, its call of ``_far_rounds``: :func:`resolve_near`
returns exactly the array that tpucomp hands to the far rounds.
:func:`resolve_near` launches ``csrc/resolve_near.cu`` on CUDA tensors
and runs :func:`resolve_near_ref` on CPU tensors.

Each row of U output positions (any multiple of 512: 4096 for LZNT1's
chunks, 65536 for the batched decodes' blocks, up to 131072 for the
one-shot XH decode's ``[history | block]`` rows) is cut into 512-byte
segments, each resolved independently.  A literal resolves to its byte.  A copy
whose source lies inside the segment takes the source's resolved value
(so far tags propagate through in-segment copies); any other copy becomes
``FAR_TAG | max(segment_base + j - disp, 0)``, an absolute source that
the far levels resolve.  The near/far boundary must sit exactly where
tpucomp draws it, or the far levels' state differs.
"""

from __future__ import annotations

import torch

from .. import stats
from . import _build
from .common import FAR_TAG, MAX_RESOLVE_ROW

SEG = 512  # segment length = near window


def _check(is_copy, disp, litv):
    if is_copy.dtype != torch.bool or is_copy.dim() != 2:
        raise ValueError("is_copy must be a bool [N, U] tensor")
    U = is_copy.shape[1]
    if U % SEG or not 0 < U <= MAX_RESOLVE_ROW:
        raise ValueError(f"rows must be a multiple of {SEG} wide, at most "
                         f"{MAX_RESOLVE_ROW}, got {U}")
    for name, t in (("disp", disp), ("litv", litv)):
        if t.dtype != torch.int32 or t.shape != is_copy.shape:
            raise ValueError(f"{name} must be an int32 [N, {U}] tensor")


def resolve_near_ref(is_copy: torch.Tensor, disp: torch.Tensor,
                     litv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`resolve_near`: a loop over the 512
    segment positions, vectorised over all segments."""
    _check(is_copy, disp, litv)
    N, U = is_copy.shape
    # tpucomp's lane word clamps disp to 17 bits and masks the literal to 9
    iscp, d, lv = (t.reshape(N * (U // SEG), SEG) for t in (
        is_copy, torch.where(is_copy, disp.clamp(max=0x1FFFF), 0),
        litv & 0x1FF))
    base = (torch.arange(iscp.shape[0], dtype=torch.int32,
                         device=iscp.device) % (U // SEG)) * SEG
    out = torch.zeros_like(d)
    for j in range(SEG):
        dj = d[:, j]
        near = (dj >= 1) & (dj <= j)
        src = torch.where(near, j - dj, 0).long()
        nearval = out.gather(1, src[:, None])[:, 0]
        farptr = FAR_TAG | (base + j - dj).clamp(min=0)
        out[:, j] = torch.where(iscp[:, j],
                                torch.where(near, nearval, farptr),
                                lv[:, j])
    return out.reshape(N, U)


def resolve_near(is_copy: torch.Tensor, disp: torch.Tensor,
                 litv: torch.Tensor) -> torch.Tensor:
    """Resolve copies within each 512-byte segment; tag the rest far.

    Args:
      is_copy: bool [N, U], the position is inside a copy token; U is a
               multiple of 512, at most 131072.
      disp:    int32 [N, U], its displacement (>= 0, clamped to 17 bits;
               used where is_copy).
      litv:    int32 [N, U], the literal byte elsewhere.

    Returns int32 [N, U]: a byte, or ``FAR_TAG | absolute_source``.
    """
    if not _build.use_kernel(is_copy, disp, litv):
        return resolve_near_ref(is_copy, disp, litv)
    _check(is_copy, disp, litv)
    is_copy, disp, litv = (t.contiguous() for t in (is_copy, disp, litv))
    out = torch.empty_like(disp)
    N, U = out.shape
    if N:
        _build.launch("resolve_near", [is_copy, disp, litv, out],
                      [N * (U // SEG), U // SEG])
        stats.launched(resolve_near)
    return out


resolve_near.launches = 0

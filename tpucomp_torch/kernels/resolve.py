"""Near-window copy resolution over 512-byte segments.

Counterpart of ``tpucomp/kernels/resolve_pallas.py`` ``resolve_copies``
up to, not including, its call of ``_far_rounds``: :func:`resolve_near`
returns exactly the array that tpucomp hands to the far rounds.
:func:`resolve_near` launches ``csrc/resolve_near.cu`` on CUDA tensors
and runs :func:`resolve_near_ref` on CPU tensors.

Each row of U = 4096 output positions is cut into 512-byte segments, each
walked in order.  A literal resolves to its byte.  A copy whose source
lies inside the segment takes the source's resolved value (so far tags
propagate through in-segment copies); any other copy becomes
``FAR_TAG | max(segment_base + j - disp, 0)``, an absolute source that
the far level resolves.  The near/far boundary must sit exactly where
tpucomp draws it, or the far level's state differs.
"""

from __future__ import annotations

import torch

from . import _build
from .common import FAR_TAG

U = 4096
SEG = 512  # segment length = near window


def _check(is_copy, disp, litv):
    if is_copy.dtype != torch.bool or is_copy.dim() != 2:
        raise ValueError("is_copy must be a bool [N, 4096] tensor")
    if is_copy.shape[1] != U:
        raise ValueError(f"rows must be {U} wide, got {is_copy.shape[1]}")
    for name, t in (("disp", disp), ("litv", litv)):
        if t.dtype != torch.int32 or t.shape != is_copy.shape:
            raise ValueError(f"{name} must be an int32 [N, {U}] tensor")


def resolve_near_ref(is_copy: torch.Tensor, disp: torch.Tensor,
                     litv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`resolve_near`: a loop over the 512
    segment positions, vectorised over all segments."""
    _check(is_copy, disp, litv)
    N = is_copy.shape[0]
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
      is_copy: bool [N, 4096], the position is inside a copy token.
      disp:    int32 [N, 4096], its displacement (>= 0, clamped to 17
               bits; used where is_copy).
      litv:    int32 [N, 4096], the literal byte elsewhere.

    Returns int32 [N, 4096]: a byte, or ``FAR_TAG | absolute_source``.
    """
    if not _build.use_kernel(is_copy, disp, litv):
        return resolve_near_ref(is_copy, disp, litv)
    _check(is_copy, disp, litv)
    is_copy, disp, litv = (t.contiguous() for t in (is_copy, disp, litv))
    out = torch.empty_like(disp)
    if out.shape[0]:
        _build.launch("resolve_near", [is_copy, disp, litv, out],
                      [out.shape[0] * (U // SEG)])
        resolve_near.launches += 1
    return out


resolve_near.launches = 0

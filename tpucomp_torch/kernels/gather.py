"""The far level of copy resolution: pointer doubling over whole rows.

Counterpart of ``tpucomp/kernels/gather_pallas.py`` ``gather18_stacked``
together with the round loop of ``common._far_level_segmented`` that
drives it, as ``common._far_rounds`` runs them for LZNT1 (U = S = 4096,
at most ``FAR_MAX_ROUNDS`` rounds, leftover tags zeroed).  :func:`far_level`
launches ``csrc/far_level.cu``, which runs every round in one launch, on
CUDA tensors and :func:`far_level_ref` on CPU tensors.

State per position, 18 bits: a resolved byte, or ``(1 << 17) | src``.  A
round sets ``st[j] = st[src]`` wherever a tag is live; a fetched tag is
the target's own pointer, so every chain halves per round.
"""

from __future__ import annotations

import torch

from . import _build
from .common import FAR_MAX_ROUNDS, FAR_ROW, FAR_TAG

U = FAR_ROW


def gather18_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[n, q] = table[n, idx[n, q]] & 0x3FFFF (18-bit values); an index
    outside [0, K) reads 0, as in ``gather_pallas.gather18_stacked``."""
    ok = (idx >= 0) & (idx < table.shape[1])
    got = table.gather(1, torch.where(ok, idx, 0).long())
    return torch.where(ok, got & 0x3FFFF, 0)


def _check(out):
    if out.dtype != torch.int32 or out.dim() != 2 or out.shape[1] != U:
        raise ValueError(f"far level takes an int32 [N, {U}] tensor")


def far_level_ref(out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`far_level`: a ``torch.gather``
    round loop, stopped when no row has a live tag, as tpucomp's
    ``while_loop`` is."""
    _check(out)
    tagged = (out & FAR_TAG) != 0
    st = torch.where(tagged, (1 << 17) | (out & (FAR_TAG - 1)), out & 0x1FF)
    for _ in range(FAR_MAX_ROUNDS):
        srcp = st & 0x1FFFF
        chase = ((st >> 17) == 1) & (srcp < U)
        if not bool(chase.any()):
            break
        st = torch.where(chase, gather18_ref(st, torch.where(chase, srcp, 0)),
                         st)
    live = (st >> 17) == 1
    res = torch.where(live, FAR_TAG | (st & 0x1FFFF), st & 0x1FF)
    # tags left after the round cap (only corrupt, cyclic streams): zero
    return torch.where((res & FAR_TAG) != 0, 0, res)


def far_level(out: torch.Tensor) -> torch.Tensor:
    """Resolve the far tags that :func:`resolve.resolve_near` left.

    Takes and returns int32 [N, 4096]; the result holds bytes, with 0
    where a tag survived the round cap.
    """
    if not _build.use_kernel(out):
        return far_level_ref(out)
    _check(out)
    src = out.contiguous()
    res = torch.empty_like(src)
    if res.shape[0]:
        _build.launch("far_level", [src, res], [res.shape[0]])
        far_level.launches += 1
    return res


far_level.launches = 0

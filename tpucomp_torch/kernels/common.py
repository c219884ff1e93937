"""The pieces of ``tpucomp.kernels.common`` that LZNT1 decode uses.

``fill_records_delta`` is XLA in tpucomp, not Pallas, so it stays plain
PyTorch here.  The far tail of copy resolution (tpucomp's ``_far_rounds``
→ ``_far_level_segmented(out, 4096, 4096)``) is one CUDA kernel:
:func:`tpucomp_torch.kernels.gather.far_level`.
"""

from __future__ import annotations

import torch

FAR_TAG = 1 << 24  # out-value tag: "pointer to earlier output position"
SENT_KEY = 1 << 28  # empty-record key (the parse's SENT)

# tpucomp._far_rounds at U = 4096, as LZNT1 calls it (min_hop = 512): no
# 4 KiB segment level runs (``4096 < U`` is false), so only the full-row
# level does, capped at bitlen(4095) + 3 rounds (common.py:1674).
FAR_ROW = 4096
FAR_MAX_ROUNDS = (FAR_ROW - 1).bit_length() + 3


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

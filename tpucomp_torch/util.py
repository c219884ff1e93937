"""Small host helpers shared by the port's codecs."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for a public entry point's ``device`` argument.

    Raises when CUDA is asked for and is not available: the port never
    carries on on the CPU by itself.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False")
    return dev


def unit_rows(units: list, width: int, device):
    """Byte units of at most ``width`` bytes -> (uint8 [N, width] rows,
    zero-padded, and int32 [N] lengths) on ``device``."""
    rows = np.zeros((len(units), width), np.uint8)
    ulen = np.zeros(len(units), np.int32)
    for i, u in enumerate(units):
        rows[i, :len(u)] = np.frombuffer(u, np.uint8)
        ulen[i] = len(u)
    return torch.from_numpy(rows).to(device), torch.from_numpy(ulen).to(device)


def row_streams(payload: torch.Tensor, plen: torch.Tensor) -> list:
    """Each row's first ``plen[i]`` bytes, as bytes, on the host."""
    payload, plen = payload.cpu().numpy(), plen.cpu().numpy()
    return [payload[i, :plen[i]].tobytes() for i in range(len(plen))]

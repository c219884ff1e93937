"""Small host helpers shared by the port's codecs."""

from __future__ import annotations

import numpy as np
import torch

from .stats import count, span


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


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array copied to ``device``: a ``copy.h2d`` span counting
    its bytes (``h2d_bytes``)."""
    t = torch.from_numpy(a)
    with span("copy.h2d", "copy"):
        count("h2d_bytes", t.nbytes)
        return t.to(device)


def to_host(t: torch.Tensor, site: str) -> np.ndarray:
    """A device tensor copied back as a NumPy array: the sync span
    ``site`` counting its bytes (``d2h_bytes``)."""
    with span(site, "sync"):
        count("d2h_bytes", t.nbytes)
        return t.cpu().numpy()


def any_set(t: torch.Tensor, site: str) -> bool:
    """Whether any element of a device tensor is set: the sync span
    ``site``."""
    with span(site, "sync"):
        return bool(t.any())


@span("util.unit_rows", "stage")
def unit_rows(units: list, width: int, device):
    """Byte units of at most ``width`` bytes -> (uint8 [N, width] rows,
    zero-padded, and int32 [N] lengths) on ``device``."""
    rows = np.zeros((len(units), width), np.uint8)
    ulen = np.zeros(len(units), np.int32)
    for i, u in enumerate(units):
        rows[i, :len(u)] = np.frombuffer(u, np.uint8)
        ulen[i] = len(u)
    return to_device(rows, device), to_device(ulen, device)


@span("util.row_streams", "stage")
def row_streams(payload: torch.Tensor, plen: torch.Tensor) -> list:
    """Each row's first ``plen[i]`` bytes, as bytes, on the host."""
    payload = to_host(payload, "sync.row_payload")
    plen = to_host(plen, "sync.row_plen")
    return [payload[i, :plen[i]].tobytes() for i in range(len(plen))]

"""Small host helpers shared by the port's codecs."""

from __future__ import annotations

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

"""The data-parallel layout: one process per GPU (``tpucomp.dist.mesh``).

tpucomp's mesh is a 1-D ``('data',)`` ``jax.sharding.Mesh`` over every
device; the port's is the default ``torch.distributed`` process group,
one rank per GPU, each rank on its own device.  The caller sets the group
up (``torch.distributed.init_process_group``), as tpucomp's caller runs
``jax.distributed.initialize()``; with no group the world is this one
process.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..util import resolve_device


@dataclass(frozen=True)
class DataMesh:
    """This process's place in the data-parallel world."""

    rank: int
    world_size: int
    device: torch.device
    backend: Optional[str]  # the group's backend; None with no group


def local_device_count() -> int:
    return torch.cuda.device_count()


def data_mesh(device="cuda") -> DataMesh:
    """This rank's :class:`DataMesh` over the default process group.

    With no group initialised: rank 0 of a world of one, on ``device``.
    With a group: a bare ``"cuda"`` becomes ``cuda:{LOCAL_RANK % the
    visible devices}``; any other ``device`` is taken as given (the CPU
    tests pass ``"cpu"``).
    """
    if not (dist.is_available() and dist.is_initialized()):
        return DataMesh(0, 1, resolve_device(device), None)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return DataMesh(dist.get_rank(), dist.get_world_size(),
                    resolve_device(dev), dist.get_backend())

"""Data parallelism over GPUs: the port of ``tpucomp.dist``.

Compression units (LZNT1 4 KiB chunks, Xpress/XH 64 KiB blocks) are
independent by format design, so data parallelism over units is the one
axis that applies.  tpucomp shards unit batches over a 1-D ``('data',)``
JAX mesh under GSPMD; the port runs one process per GPU in a
``torch.distributed`` group, each rank coding a contiguous share of the
units on its own device.  Ragged outputs travel as rows padded to the
longest plus their true lengths, and every rank stitches them in unit
order.

    import torch.distributed as dist
    from tpucomp_torch.dist import ShardedCodec, data_mesh

    dist.init_process_group("nccl", init_method="tcp://host:port",
                            world_size=W, rank=r)   # or none: one rank
    codec = ShardedCodec("xpress_huff", mesh=data_mesh())
    archive = codec.compress(data)              # an Archive, on every rank
    assert codec.decompress(archive) == data
"""

from .mesh import DataMesh, data_mesh, local_device_count  # noqa: F401
from .batch import ShardedLZNT1  # noqa: F401
from .archive import Archive, Manifest  # noqa: F401
from .sharded import ShardedCodec  # noqa: F401
from .mixed import MixedBatch  # noqa: F401

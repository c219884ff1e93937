"""tpucomp_torch: the PyTorch/CUDA port of tpucomp, beside it.

tpucomp (JAX, Pallas kernels for the TPU) stays the reference; this
package computes the same functions with PyTorch and CUDA kernels written
by hand for Hopper (``kernels/csrc``, built by nvcc at first use into
``tpucomp_torch/_build/``).  It never imports JAX.

Ported: LZNT1 encode and decode, plain Xpress unit encode and
decode (one-shot decode up to 64 KiB; one-shot encode of any length, one
stream), Xpress Huffman encode and decode (one-shot, multi-block
streams included, and batched), and the dist layer
(:mod:`tpucomp_torch.dist`: ``ShardedCodec`` archives with resume and
the resolved profile, ``ShardedLZNT1``, ``MixedBatch``, one process per
GPU over ``torch.distributed``) with its per-run stats
(:mod:`tpucomp_torch.stats`), the streaming ``Compressor`` /
``Decompressor``, and the host backends (``backend="cpu"``: the port's
copy of the native C codec; ``backend="oracle"``: its copy of the
pure-Python spec codecs).  So the port does all that tpucomp does.
Unlike tpucomp's, whose default ``"auto"`` picks a host codec, every
entry point defaults to ``backend="device"`` on ``device="cuda"``.

    import tpucomp_torch
    stream = tpucomp_torch.compress("lznt1", data)              # on "cuda"
    streams = tpucomp_torch.compress_batch("lznt1", units)      # <= 4 KiB each
    data = tpucomp_torch.decompress("lznt1", stream)            # on "cuda"
    data = tpucomp_torch.decompress("lznt1", stream, device="cpu")
    units = tpucomp_torch.decompress_batch("lznt1", unit_streams)
    units = tpucomp_torch.decompress_batch("xpress_huff", unit_streams,
                                           out_lens)          # 64 KiB units
    data = tpucomp_torch.decompress("xpress_huff", stream, out_len)
    streams = tpucomp_torch.compress_batch("xpress", units)    # <= 64 KiB each
    units = tpucomp_torch.decompress_batch("xpress", streams, out_lens)
    stream = tpucomp_torch.compress("xpress", data)            # any length
    stream = tpucomp_torch.compress("xpress_huff", data)       # 64 KiB blocks
    streams = tpucomp_torch.compress_batch("xpress_huff", units)
    stream = tpucomp_torch.compress("xpress", data, backend="cpu")

    c = tpucomp_torch.Compressor("lznt1")                      # on "cuda"
    stream = c.compress(part1) + c.compress(part2) + c.flush()
    d = tpucomp_torch.Decompressor("xpress_huff", backend="cpu",
                                   out_len=n)
    data = d.decompress(stream[:1000]) + d.decompress(stream[1000:])

    from tpucomp_torch.dist import ShardedCodec
    archive = ShardedCodec("xpress_huff").compress(data)      # an Archive
    data = ShardedCodec("xpress_huff").decompress(archive)

On CPU tensors (``device="cpu"``) every kernel's plain PyTorch version
runs instead.
"""

from .errors import (  # noqa: F401
    ArgError,
    BufError,
    DataError,
    MemError,
    MSCompError,
    Status,
    UnsupportedFormatError,
)
from .formats import Format  # noqa: F401
from .api import (  # noqa: F401
    Compressor,
    Decompressor,
    compress,
    compress_batch,
    decompress,
    decompress_batch,
    max_compressed_size,
)

__version__ = "0.1.0"

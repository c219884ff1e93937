"""tpucomp_torch: the PyTorch/CUDA port of tpucomp, beside it.

tpucomp (JAX, Pallas kernels for the TPU) stays the reference; this
package computes the same functions with PyTorch and CUDA kernels written
by hand for Hopper (``kernels/csrc``, built by nvcc at first use into
``tpucomp_torch/_build/``).  It never imports JAX.

Ported so far: LZNT1 decode.

    import tpucomp_torch
    data = tpucomp_torch.decompress("lznt1", stream)            # on "cuda"
    data = tpucomp_torch.decompress("lznt1", stream, device="cpu")
    units = tpucomp_torch.decompress_batch("lznt1", unit_streams)

On CPU tensors every kernel's plain PyTorch version runs instead.
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
from .api import decompress, decompress_batch  # noqa: F401

__version__ = "0.1.0"

"""tpucomp_torch's row gather (``kernels.gather.gather_rows``), in its plain
PyTorch version on the CPU, against tpucomp's Pallas ``gather_rows_fused``
in interpret mode at that kernel's own shapes (K = 16384, where an index
past the table is selected to 0, and K = 20000, where it reads the padded
zero tail) and against its XLA form ``mxu_gather_rows`` at the XH
encoder's K = 512.  Indices below 0, at K and past it; values with bits
20-31 set, kept to whole byte planes.  Every value is an integer, so the
tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucomp.kernels.common import mxu_gather_rows
from tpucomp.kernels.gather_pallas import gather_rows_fused
from tpucomp_torch.kernels import gather

N, Q = 3, 2000


def _inputs(K, seed):
    """int32 [N, K] values over all 32 bits (bits 20-31 set in most) and
    [N, Q] indices, a tenth of them outside [0, K): below 0, at K, past
    it, and the int32 extremes."""
    r = np.random.default_rng(seed)
    data = r.integers(-(1 << 31), 1 << 31, (N, K), dtype=np.int64)
    data = data.astype(np.int32)
    idx = r.integers(0, K, (N, Q)).astype(np.int32)
    bad = r.random((N, Q)) < 0.1
    idx[bad] = r.choice([-1, -K, K, K + 1, 2 * K, -(1 << 31), (1 << 31) - 1],
                        int(bad.sum()))
    idx[:, :4] = [0, K - 1, K, -1]
    return data, idx


@pytest.mark.parametrize("nbits", [9, 18, 20, 32])
@pytest.mark.parametrize("K", [16384, 20000])
def test_gather_rows_matches_pallas_interpret(K, nbits):
    data, idx = _inputs(K, K + nbits)
    want = np.asarray(gather_rows_fused(jnp.asarray(data), jnp.asarray(idx),
                                        nbits=nbits, interpret=True))
    got = gather.gather_rows(torch.from_numpy(data), torch.from_numpy(idx),
                             nbits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nbits", [20, 32])
def test_gather_rows_matches_xla_at_lookup_width(nbits):
    """The XH encoder's lookup: a 512-entry table of (code << 5) | len."""
    data, idx = _inputs(512, nbits)
    want = np.asarray(mxu_gather_rows(jnp.asarray(data), jnp.asarray(idx),
                                      nbits=nbits))
    got = gather.gather_rows(torch.from_numpy(data), torch.from_numpy(idx),
                             nbits)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plane_mask_and_refusals():
    assert [gather.plane_mask(b) for b in (1, 8, 9, 18, 20, 24, 25, 32)] == \
        [0xFF, 0xFF, 0xFFFF, 0xFFFFFF, 0xFFFFFF, 0xFFFFFF, -1, -1]
    data = torch.arange(10, dtype=torch.int32)[None]
    idx = torch.tensor([[3, -1, 10]], dtype=torch.int32)
    assert gather.gather_rows(data, idx, 8).tolist() == [[3, 0, 0]]
    with pytest.raises(ValueError, match="nbits"):
        gather.gather_rows(data, idx, 0)
    with pytest.raises(ValueError, match="int32"):
        gather.gather_rows(data, idx.long())
    with pytest.raises(ValueError, match="int32"):
        gather.gather_rows(data, idx.expand(2, 3))

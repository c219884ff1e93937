"""tpucomp_torch's row sort on the CPU, on the keys that steer its radix
passes: keys that vary only in their top bits (the sign bit among them),
only in the high byte, only in bit 31, in bits that start above bit 0,
the widest keys of both signs, and rows of width 1.

The plain version, which the wrapper runs on CPU tensors, is held to
tpucomp's ``bitonic_sort_rows`` in interpret mode and to ``lax.sort``,
exactly, on the same seeded numpy planes.  ``digit_passes``, the number of
passes the CUDA kernel runs on a row, is held to counts worked out by
hand.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tpucomp.kernels import sort_pallas
from tpucomp_torch.kernels import match, sort


def _keys(kind, U, r):
    """Eight rows of U unique keys of one kind, int64."""
    perm = np.stack([r.permutation(U) for _ in range(8)]).astype(np.int64)
    top = max(1, (U - 1).bit_length())
    if kind == "top bits":  # the sign bit among them
        return (perm << (32 - top)) - (1 << 31)
    if kind == "high byte":  # U <= 256
        return (perm << 24) - (1 << 31)
    if kind == "bit 31":  # U <= 2
        return -(perm << 31)
    if kind == "low bits equal":  # the passes start at bit 7
        return (perm << 7) | 0x55
    assert kind == "widest"  # INT32_MAX and INT32_MIN and their neighbours
    return np.where(perm % 2 == 0, (1 << 31) - 1 - perm // 2,
                    -(1 << 31) + perm // 2)


@pytest.mark.parametrize("kind,U", [
    ("top bits", 1024), ("top bits", 1), ("high byte", 256), ("bit 31", 2),
    ("low bits equal", 512), ("widest", 256)])
def test_sort_rows_edge_keys_match_tpucomp(kind, U):
    r = np.random.default_rng(U + len(kind))
    key = _keys(kind, U, r).astype(np.int32)
    assert all(len(set(row)) == U for row in key.tolist())
    planes = [key, r.integers(-(1 << 31), 1 << 31, key.shape).astype(np.int32)]
    got = sort.sort_rows([torch.from_numpy(p) for p in planes])
    want_k = sort_pallas.bitonic_sort_rows(
        [jnp.asarray(p) for p in planes], interpret=True)
    want_x = lax.sort([jnp.asarray(p) for p in planes], dimension=1,
                      num_keys=1)
    for g, wk, wx in zip(got, want_k, want_x):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(g.numpy(), np.asarray(wx))


def _hash_keys(U, pos_bits):
    r = np.random.default_rng(U)
    x = torch.from_numpy(r.integers(0, 256, (2, U), dtype=np.uint8))
    return match.hash_keys(x, 13, pos_bits)


@pytest.mark.parametrize("case,want", [
    ("permutation 4096", 2),  # 12 bits: 6 + 6
    ("permutation 65536", 2),  # 16 bits in tiles: 8 + 8
    ("hash key 4096", 3),  # 13 + 12 bits: 9 + 9 + 7
    ("hash key 65536", 4),  # 13 + 16 bits in tiles: 8 + 8 + 8 + 5
    ("width 1", 0), ("equal keys", 0), ("bit 31", 1), ("high byte", 1),
    ("low bits equal", 2), ("all 32 bits", 4)])
def test_digit_passes(case, want):
    r = np.random.default_rng(5)
    key = {
        "permutation 4096": lambda: torch.from_numpy(
            r.permutation(4096).astype(np.int32)[None]),
        "permutation 65536": lambda: torch.from_numpy(
            r.permutation(65536).astype(np.int32)[None]),
        "hash key 4096": lambda: _hash_keys(4096, 12),
        "hash key 65536": lambda: _hash_keys(65536, 16),
        "width 1": lambda: torch.tensor([[-7], [3]], dtype=torch.int32),
        "equal keys": lambda: torch.full((2, 100), 9, dtype=torch.int32),
        "bit 31": lambda: torch.from_numpy(
            _keys("bit 31", 2, r).astype(np.int32)),
        "high byte": lambda: torch.from_numpy(
            _keys("high byte", 256, r).astype(np.int32)),
        "low bits equal": lambda: torch.from_numpy(
            _keys("low bits equal", 4096, r).astype(np.int32)),
        "all 32 bits": lambda: torch.tensor([[0, -1]], dtype=torch.int32),
    }[case]()
    assert sort.digit_passes(key).tolist() == [want] * key.shape[0]

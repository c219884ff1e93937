"""``util.row_bytes`` (the split of decoded rows into bytes, by a few
threads for a large batch) and ``util.staging_rows`` on the CPU."""

import numpy as np
import pytest

from tpucomp_torch import util


def _rows(n, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, w), np.uint8)


@pytest.mark.parametrize("n,w,parallel", [
    (1, 1, False), (5, 300, False), (160, 65536, True), (7, 1 << 20, True)])
def test_row_bytes_equals_each_rows_prefix(n, w, parallel):
    rows = _rows(n, w)
    rng = np.random.default_rng(n)
    lens = [w, 0] + [int(v) for v in rng.integers(0, w + 1, n)][:max(0, n - 2)]
    lens = lens[:n]
    assert (sum(lens) >= util.SPLIT_PARALLEL_BYTES) == parallel
    got = util.row_bytes(rows, lens)
    assert [type(b) for b in got] == [bytes] * n
    assert got == [rows[i, :o].tobytes() for i, o in enumerate(lens)]
    rows[:] = 0  # the bytes are copies, not views of the rows
    assert got == [_rows(n, w)[i, :o].tobytes() for i, o in enumerate(lens)]


def test_row_bytes_of_a_row_slice_and_empty_batch():
    rows = _rows(64, 131072, 3)[:, 1000:66536]
    lens = [65536] * 64
    assert util.row_bytes(rows, lens) == [r.tobytes() for r in rows]
    assert util.row_bytes(np.zeros((0, 16), np.uint8), []) == []


@pytest.mark.parametrize("rows,lens", [
    (np.zeros((2, 8), np.uint8), [8]),
    (np.zeros((2, 8), np.uint8), [9, 0]),
    (np.zeros((2, 8), np.uint8), [-1, 0]),
    (np.zeros((2, 8), np.int32), [1, 1]),
    (np.zeros((8, 2), np.uint8).T, [1, 1]),
])
def test_row_bytes_refuses(rows, lens):
    with pytest.raises(ValueError):
        util.row_bytes(rows, lens)


def test_staging_rows_on_the_cpu():
    a = util.staging_rows(3, 48, "cpu")
    assert a.shape == (3, 48) and a.dtype == np.uint8 and a.flags.writeable


@pytest.fixture
def dev():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pinned_copy_back_and_staging_on_card(dev):
    import torch

    t = torch.randint(0, 256, (96, 65536), dtype=torch.uint8, device=dev)
    host = util.to_host(t, "sync.test", pinned=True)
    assert host.base is not None and torch.from_numpy(host).is_pinned()
    np.testing.assert_array_equal(host, t.cpu().numpy())
    lens = [65536 - 7 * i for i in range(96)]
    assert util.row_bytes(host, lens) == [
        t[i, :o].cpu().numpy().tobytes() for i, o in enumerate(lens)]
    rows = util.staging_rows(4, 32, dev)
    assert torch.from_numpy(rows).is_pinned()
    rows[:] = 7
    assert torch.equal(util.to_device(rows, dev).cpu(),
                       torch.full((4, 32), 7, dtype=torch.uint8))


@pytest.mark.cuda
def test_xpress_batch_over_the_parallel_split_on_card(dev):
    import tpucomp_torch as tt

    r = np.random.default_rng(5)
    units = [bytes(r.integers(0, 4, 65536 - 4096 * (i % 3), np.uint8))
             for i in range(80)] + [b""]
    streams = tt.compress_batch("xpress", units, device=dev)
    assert sum(map(len, units)) >= util.SPLIT_PARALLEL_BYTES
    assert tt.decompress_batch("xpress", streams, list(map(len, units)),
                               device=dev) == units

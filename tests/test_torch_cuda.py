"""tpucomp_torch's CUDA kernels against their plain PyTorch versions on
the card, at small seeded shapes that hold each kernel's edge cases.

Every test needs a CUDA card and skips without one.  The file imports
neither JAX nor tpucomp, and runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` sets JAX up for the other files.)
"""

import numpy as np
import pytest
import torch

from tpucomp_torch.codecs import lznt1 as lz
from tpucomp_torch.kernels import common, gather, lznt1_parse, resolve

pytestmark = pytest.mark.cuda

U = lz.CHUNK


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


def _parse_batch(dev):
    """Random token streams of every length (most malformed), hand-built
    malformed chunks, stored-raw and empty rows, and an all-literal one."""
    r = np.random.default_rng(1)
    N = 40
    payload = r.integers(0, 256, (N, lz.PAYLOAD_PAD), dtype=np.uint8)
    plen = r.integers(0, lz.PAYLOAD_PAD + 1, N).astype(np.int32)
    is_comp = r.random(N) < 0.8
    payload[0, :3], plen[0] = (1, 0, 0), 3  # disp 1 > p = 0
    payload[1, :2], plen[1] = (1, 7), 2  # ends after a copy's lo byte
    payload[2, :4], plen[2] = (0, 65, 66, 67), 4  # three literals: fine
    plen[3] = 0
    payload[4], plen[4] = 0, lz.PAYLOAD_PAD  # literals past 4096
    is_comp[:5] = True
    return lz.batch_from_numpy(payload.astype(np.int32), plen, is_comp, dev)


def test_parse_kernel_matches_plain(dev):
    batch = _parse_batch(dev)
    before = lznt1_parse.lznt1_parse.launches
    got = lznt1_parse.lznt1_parse(*batch)
    assert lznt1_parse.lznt1_parse.launches == before + 1
    want = lznt1_parse.lznt1_parse_ref(*batch)
    _assert_equal(got, want)
    err = want[3].cpu()
    assert err[:2].tolist() == [1, 1] and err[2] == 0 and err.sum() > 5
    assert want[2][4] == U  # the output filled; later bytes are ignored


def test_resolve_kernel_matches_plain(dev):
    r = np.random.default_rng(2)
    shape = (5, U)
    is_copy = torch.from_numpy(r.random(shape) < 0.6)
    disp = torch.from_numpy(np.where(
        r.random(shape) < 0.7, r.integers(0, 40, shape),
        r.integers(1, 5000, shape)).astype(np.int32))
    disp[0, ::97] = 0x30000  # clamped to 17 bits
    litv = torch.from_numpy(r.integers(0, 512, shape).astype(np.int32))
    args = [t.to(dev) for t in (is_copy, disp, litv)]
    _assert_equal([resolve.resolve_near(*args)],
                  [resolve.resolve_near_ref(*args)])


def test_far_level_kernel_matches_plain(dev):
    r = np.random.default_rng(3)
    x = r.integers(0, 256, (4, U)).astype(np.int32)
    tag = r.random((4, U)) < 0.5
    x[tag] = common.FAR_TAG | r.integers(0, U, tag.sum())
    x[1, 100], x[1, 200] = common.FAR_TAG | 200, common.FAR_TAG | 100  # cycle
    x[2, 7] = common.FAR_TAG | 9000  # outside the row: never chased
    x[2, 8:4000] = common.FAR_TAG | np.arange(7, 3999)  # one long chain
    x[3] = r.integers(0, 256, U)  # no tag at all
    xs = torch.from_numpy(x).to(dev)
    _assert_equal([gather.far_level(xs)], [gather.far_level_ref(xs)])


def test_decode_batch_on_card_matches_cpu(dev):
    batch = _parse_batch(dev)
    got = lz.decode_batch(*batch)
    want = lz.decode_batch(*(t.cpu() for t in batch))
    _assert_equal(got, want)


def test_empty_batch_launches_nothing(dev):
    batch = [t[:0] for t in _parse_batch(dev)]
    before = lznt1_parse.lznt1_parse.launches
    out, out_len, err = lz.decode_batch(*batch)
    assert out.shape == (0, U) and lznt1_parse.lznt1_parse.launches == before

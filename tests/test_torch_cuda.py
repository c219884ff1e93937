"""tpucomp_torch's CUDA kernels against their plain PyTorch versions on
the card, at small seeded shapes that hold each kernel's edge cases.

Every test needs a CUDA card and skips without one.  The file imports
neither JAX nor tpucomp, and runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` sets JAX up for the other files.)
The Xpress Huffman streams come from the repo's native C encoder, which
``chip_smoke.Native`` builds with the host C compiler.
"""

import numpy as np
import pytest
import torch

from chip_smoke import Native
from tpucomp_torch.codecs import lznt1 as lz
from tpucomp_torch.codecs import xpress_huff as xh
from tpucomp_torch.kernels import common, fill, gather, lznt1_parse, resolve
from tpucomp_torch.kernels import xh_parse

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


XU = 16384  # Xpress Huffman rows: every far level runs


def _xh_units():
    """Short units (the plain parse loops once per body byte) in 16 KiB
    rows: text-like, periodic, random (substep tier 3) and zeros (17)."""
    r = np.random.default_rng(6)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"pi ", b"rho "]
    text = b"".join(words[i] for i in r.integers(0, len(words), 1200))
    return [text[:5000], (b"abcabd" * 1500)[:8000] + text[:2000],
            r.permutation(np.tile(np.arange(256, dtype=np.uint8), 12))
            .tobytes(), bytes(XU)]


def _xh_batch(dev, native):
    """Valid units, their archive (resolved) encoding, and malformed rows:
    cut short, flipped bits, random code lengths, shorter than the table."""
    r = np.random.default_rng(8)
    units = _xh_units()
    streams = [native.xh_compress(u) for u in units]
    streams.append(native.xh_compress_opt(units[0],
                                          Native.OPT_RESOLVE_OFFSETS | 2 << 8))
    lens = [len(u) for u in units] + [len(units[0])]
    s = streams[0]
    flipped = bytearray(s)
    flipped[400] ^= 0x24
    streams += [s[:len(s) // 2], bytes(flipped),
                r.integers(0, 256, 256, dtype=np.uint8).tobytes() + s[256:],
                s[:100]]
    lens += [lens[0]] * 4
    return xh.pack_units(streams, lens, XU, dev), units


def test_xh_parse_kernel_matches_plain(dev):
    batch, units = _xh_batch(dev, Native())
    args = xh.parse_inputs(*batch)
    before = xh_parse.xh_parse.launches
    got = xh_parse.xh_parse(*args, XU)
    assert xh_parse.xh_parse.launches == before + 1
    want = xh_parse.xh_parse_ref(*args, XU)
    _assert_equal(got, want)
    bad = ((want[3] != 0) | (want[2] < batch[2])).cpu()
    assert not bad[:len(units) + 1].any() and bad[len(units) + 1:].sum() >= 2
    assert set(batch[3].tolist()) >= {3, 5, 17}


def test_fill_kernel_matches_plain(dev):
    """Monotone records with adjacent repeats and SENT or -1 gaps, R below
    and above U, and a keep that binds."""
    r = np.random.default_rng(9)
    W = 4096
    for R in (3000, 9000):
        pos = np.sort(r.integers(-3, W + 40, (6, R)), axis=1).astype(np.int32)
        pos[r.random((6, R)) < 0.2] = common.SENT_KEY
        pos[1] = -1
        val = r.integers(0, 1 << 23, (6, R)).astype(np.int32)
        args = [torch.from_numpy(a).to(dev) for a in (pos, val)]
        for keep in (None, 500):
            _assert_equal(fill.fill_records_delta2(*args, W, keep),
                          fill.fill_records_delta2_ref(*args, W, keep))


def _far_states(width):
    """Near-walk-shaped states: chains within and across 4 KiB segments,
    cycles, and sources outside the row or past 17 bits."""
    r = np.random.default_rng(10)
    x = r.integers(0, 256, (4, width)).astype(np.int32)
    tag = r.random((4, width)) < 0.5
    src = np.where(r.random((4, width)) < 0.5,
                   r.integers(0, 4096, (4, width)),
                   r.integers(0, width, (4, width)))
    x[tag] = common.FAR_TAG | src[tag]
    x[1, 100], x[1, 200] = common.FAR_TAG | 200, common.FAR_TAG | 100
    x[2, 7] = common.FAR_TAG | (width + 9)
    x[2, 8] = common.FAR_TAG | (1 << 17) | 5
    x[3, 4096:] = common.FAR_TAG | np.arange(4095, width - 1)  # long chain
    return x


@pytest.mark.parametrize("width", [XU, 65536])
def test_far_kernels_match_plain(width, dev):
    xs = torch.from_numpy(_far_states(width)).to(dev)
    seg_args = (xs, common.SEG_LEVEL, common.SEG_LEVEL_CAP, False)
    seg = gather.far_level(*seg_args)
    _assert_equal([seg], [gather.far_level_ref(*seg_args)])
    _assert_equal([gather.far_probe(seg)], [gather.far_probe_ref(seg)])
    _assert_equal([gather.far_probe(xs, 1)], [gather.far_probe_ref(xs, 1)])
    _assert_equal([gather.far_row(seg)], [gather.far_row_ref(seg)])
    _assert_equal([gather.far_row(xs)], [gather.far_row_ref(xs)])


def test_resolve_kernel_matches_plain_on_wide_rows(dev):
    r = np.random.default_rng(11)
    shape = (3, XU)
    is_copy = torch.from_numpy(r.random(shape) < 0.6)
    disp = torch.from_numpy(np.where(
        r.random(shape) < 0.7, r.integers(0, 40, shape),
        r.integers(1, 9000, shape)).astype(np.int32))
    litv = torch.from_numpy(r.integers(0, 512, shape).astype(np.int32))
    args = [t.to(dev) for t in (is_copy, disp, litv)]
    _assert_equal([resolve.resolve_near(*args)],
                  [resolve.resolve_near_ref(*args)])


@pytest.mark.parametrize("fast_resolve", [False, True])
def test_xh_decode_batch_on_card_matches_cpu(fast_resolve, dev):
    batch, units = _xh_batch(dev, Native())
    got = xh.decode_batch(*batch, XU, fast_resolve=fast_resolve)
    want = xh.decode_batch(*(t.cpu() for t in batch), XU,
                           fast_resolve=fast_resolve)
    _assert_equal(got, want)
    out = got[0].cpu().numpy()
    for k, u in enumerate(units):
        assert out[k, :len(u)].tobytes() == u

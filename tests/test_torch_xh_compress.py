"""tpucomp_torch's Xpress Huffman encode on 64 KiB rows and through the
public calls, in the plain PyTorch versions of its kernels on the CPU,
against tpucomp:

- ``encode_batch`` against ``_encode_impl`` on one 65536-wide row, at the
  default ``MatchFinderConfig`` and with ``second_hash_cands = 2``;
- ``compress`` (64 KiB blocks) and ``compress_batch`` against tpucomp's,
  the streams decoded back by the oracle, and the errors;
- ``max_compressed_size`` against ``tpucomp.max_compressed_size`` from 0
  to 300,000.

Every value is a byte or an integer, so the tolerance is exact equality.
"""

import random

import pytest

import tpucomp
import tpucomp_torch
from conftest import make_corpus
from test_torch_xh_encode import check_encode_batch
from tpucomp.codecs import xpress_huff as t_xh
from tpucomp.oracle import xpress_huff as oracle
from tpucomp_torch.codecs import xpress_huff as xh
from _threads import _one_thread  # noqa: F401


@pytest.mark.parametrize("second", [0, 2])
def test_encode_batch_matches_tpucomp_on_64KiB_rows(second, monkeypatch):
    """One row: long periodic matches, far ones, a run of 9000."""
    r = random.Random(second)
    noise = bytes(r.randrange(256) for _ in range(3000))
    unit = (noise * 22)[:65536 - 9000] + b"z" * 9000
    check_encode_batch([unit], 65536, second, monkeypatch)


def test_compress_matches_tpucomp_and_round_trips(monkeypatch):
    monkeypatch.delenv("TPUCOMP_PALLAS", raising=False)
    rng = random.Random(7)
    data = make_corpus(rng, 70000)  # two blocks, the second short
    got = tpucomp_torch.compress("xpress_huff", data, device="cpu")
    assert got == tpucomp.compress("xpress_huff", data, backend="tpu")
    assert oracle.decompress(got, len(data)) == data
    assert len(got) <= xh.max_compressed_size(len(data))
    assert tpucomp_torch.compress("xpress_huff", b"", device="cpu") == b""
    # 64 KiB rows, as compress's: tpucomp reuses its trace
    units = [data[:5000], b"", b"xyz" * 100, bytes(4096)]
    streams = tpucomp_torch.compress_batch("xpress_huff", units, device="cpu")
    assert streams == tpucomp.compress_batch("xpress_huff", units)
    assert [oracle.decompress(s, len(u)) for s, u in zip(streams, units)] \
        == units
    with pytest.raises(tpucomp_torch.ArgError, match="unit larger"):
        tpucomp_torch.compress_batch("xpress_huff", [bytes(5001)],
                                     unit_size=5000, device="cpu")
    with pytest.raises(tpucomp_torch.ArgError, match="64 KiB"):
        tpucomp_torch.compress_batch("xpress_huff", [b"a"], unit_size=65537,
                                     device="cpu")
    assert tpucomp_torch.compress_batch("xpress_huff", [], device="cpu") == []
    # the port's one-shot decode reads its own multi-block stream back
    assert tpucomp_torch.decompress("xpress_huff", got, len(data),
                                    device="cpu") == data


def test_max_compressed_size_matches_tpucomp():
    sizes = set(range(0, 300001, 997)) | {0, 1, 2, 255, 256, 257}
    for k in range(1, 5):
        sizes |= {k * 65536 - 1, k * 65536, k * 65536 + 1}
    for n in sorted(sizes):
        assert tpucomp_torch.max_compressed_size("xpress_huff", n) == \
            tpucomp.max_compressed_size("xpress_huff", n) == \
            t_xh.max_compressed_size(n)


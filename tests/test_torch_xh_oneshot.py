"""tpucomp_torch's one-shot Xpress Huffman ``decompress`` on the CPU against
tpucomp's ``codecs.xpress_huff.decompress`` (its XLA path, as its own
tests run it on the CPU): the bytes and the count of batch decodes
(tpucomp's dispatches) on each stream, ``out_len`` None and 0, the Kraft
scan, the committed cross-block vector.  The malformed streams and the
history decode's parts are in ``test_torch_xh_oneshot_history.py``.

The data stays compressible where it can (:func:`text`: the plain parse
loops once per body byte), and short, so that tpucomp's decoders take the
same shapes from stream to stream and compile once.  Every value is a byte
or an integer: the tolerance is exact equality.
"""

import functools
import hashlib
import os
import random

import numpy as np
import pytest

import tpucomp_torch
from benchmarks.corpus import _synthetic
from chip_smoke import XH_VECTOR, XH_VECTOR_INPUT_SHA256
from tpucomp import _native
from tpucomp.codecs import xpress_huff as t_xh
from tpucomp.oracle import xpress_huff as oracle
from tpucomp_torch.codecs import xpress_huff as xh
from _spans import names, totals, traced
from _threads import _one_thread  # noqa: F401

BLOCK = xh.BLOCK
VECTOR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), XH_VECTOR)


def cross_block_input() -> bytes:
    return _synthetic(3 * BLOCK)


def text(n, seed, run=(400, 500)) -> bytes:
    """n bytes of runs of ``run`` bytes (the range's) copied from a seeded
    base of 1000 printable bytes, a random byte between runs: a 64 KiB
    block encodes to about 1.5 to 2 KB, and the blocks after the first
    repeat what came before them."""
    r = random.Random(seed)
    base = bytes(r.randrange(32, 127) for _ in range(1000))
    out = bytearray()
    while len(out) < n:
        a = r.randrange(0, 1000 - run[1])
        out += base[a:a + r.randrange(*run)]
        out.append(r.randrange(32, 127))
    return bytes(out[:n])


def tpucomp_decompress(stream, n):
    """tpucomp's one-shot decode: (bytes, or the exception it raised; its
    dispatches).  Its decoders stay compiled from call to call."""
    calls = []

    class Counting(dict):
        def __getitem__(self, key):
            calls.append(key)
            return dict.__getitem__(self, key)

    kept = t_xh._SPAN_DECODERS
    t_xh._SPAN_DECODERS = Counting(kept)
    try:
        out = t_xh.decompress(stream, n)
    except Exception as e:  # noqa: BLE001 - compared with the port's
        out = e
    finally:
        kept.update(t_xh._SPAN_DECODERS)
        t_xh._SPAN_DECODERS = kept
    return out, len(calls)


def port_decompress(stream, n):
    """The port's: (bytes or the exception; its batch decodes; the names
    of its steps)."""
    out, records = traced(lambda: tpucomp_torch.decompress(
        "xpress_huff", stream, n, device="cpu"))
    return out, totals(records).get("xh.batch_decodes", 0), names(
        records, "stage")


@functools.lru_cache(maxsize=None)
def _data(name):
    r = np.random.default_rng(16)
    if name == "one_block":
        return text(BLOCK, 1)
    if name == "partial_block":
        return text(40000, 2)
    if name == "ten_blocks":  # tpucomp's test shape: a partial last block
        return text(10 * BLOCK - 1234, 3, (850, 950))  # 15.5 KB
    if name == "zeros":
        return bytes(3 * BLOCK)
    if name == "incompressible":  # every code 8 bits or more
        return r.integers(0, 256, 6000, dtype=np.uint8).tobytes()
    if name == "cross_block":
        return text(3 * BLOCK, 5)
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def _stream(name):
    if name == "cross_block":  # matches reach back across blocks
        return oracle.compress(_data(name), cross_block=True)
    return _native.xh_compress(_data(name))


def _hold(stream, n):
    """The port against tpucomp on one stream: the same bytes or the same
    error, and the same count of batch decodes.  Returns the bytes."""
    want, want_n = tpucomp_decompress(stream, n)
    got, got_n, steps = port_decompress(stream, n)
    if isinstance(want, Exception):
        assert isinstance(want, t_xh.DataError), want
        assert isinstance(got, tpucomp_torch.DataError), got
    else:
        assert not isinstance(got, Exception), got
        assert got == want
    assert got_n == want_n
    return got, got_n, steps


# each stream's batch decodes, tpucomp's own bounds where its tests state
# them: ten blocks with a partial last one take the speculative batch, one
# decode for the last link and one fixpoint pass; the cross-block stream
# more than one pass (its matches reach into the block before), at most
# 1 + 1 + 3; a stream of one block, one decode
STREAMS = {"one_block": (1, 1), "partial_block": (1, 1),
           "ten_blocks": (3, 3), "zeros": (2, 2), "incompressible": (1, 1),
           "cross_block": (3, 5)}


@pytest.mark.parametrize("name", list(STREAMS))
def test_decompress_matches_tpucomp(name):
    got, batch_decodes, steps = _hold(_stream(name), len(_data(name)))
    assert got == _data(name)
    lo, hi = STREAMS[name]
    assert lo <= batch_decodes <= hi
    if len(_data(name)) > BLOCK:  # the speculative path
        assert {"xh.kraft_scan", "xh.chain_walk", "xh.fixpoint"} <= steps
    else:
        assert "xh.sequential_walk" in steps


def test_out_len_none_and_zero():
    s = _stream("zeros")
    for call in (lambda: tpucomp_torch.decompress("xpress_huff", s,
                                                  device="cpu"),
                 lambda: xh.decompress(s, None, device="cpu")):
        with pytest.raises(tpucomp_torch.ArgError, match="out_len"):
            call()
    with pytest.raises(t_xh.ArgError):
        t_xh.decompress(s, None)
    got, batch_decodes, _ = port_decompress(s, 0)
    assert got == t_xh.decompress(s, 0) == b""
    assert batch_decodes == 0


def test_vector_is_the_oracle_stream():
    """``tests/data/xh_cross_block.bin`` (the card's cross-block stream)
    is the oracle's cross-block encoding of its input, which is what its
    sha256 says."""
    data = cross_block_input()
    assert hashlib.sha256(data).hexdigest() == XH_VECTOR_INPUT_SHA256
    with open(VECTOR, "rb") as f:
        vector = f.read()
    assert vector == oracle.compress(data, cross_block=True)
    assert oracle.decompress(vector, len(data)) == data
    # three blocks, each a candidate of the Kraft scan
    assert len(xh._kraft_candidates(np.frombuffer(vector, np.uint8))) == 3


def test_kraft_candidates_match_tpucomp():
    for name in ("ten_blocks", "zeros", "cross_block"):
        arr = np.frombuffer(_stream(name), np.uint8)
        np.testing.assert_array_equal(xh._kraft_candidates(arr),
                                      t_xh._kraft_candidates(arr))
    arr = np.frombuffer(_stream("ten_blocks"), np.uint8)
    assert xh._kraft_candidates(arr, 3) is None
    assert t_xh._kraft_candidates(arr, 3) is None
    assert len(xh._kraft_candidates(arr[:255])) == 0

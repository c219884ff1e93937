"""The hiberfil7-xpress deployment on the CPU: Windows XP-7 hibernation
sets in plain LZXPRESS, read through the port's ``decompress_batch``
against the benchmark's plain reference (``portbench/ref/xpress.py``) and
its frozen encoder (``portbench/frozen/xpress.c``), at sizes of at most
4 KiB a set."""

import functools

import numpy as np
import pytest

import tpucomp_torch as tt
from portbench import frozen, ref, spec
from portbench.data import gen
from tpucomp_torch.errors import DataError

CONFIG = spec.config("hiberfil7-xpress")


@functools.lru_cache(maxsize=None)
def _sets():
    """A zero, a text and a random page, a short set of the deployment's
    mix, and an empty set."""
    rng = gen.rng_for(0x7E5, 1)
    kinds = [gen.KINDS[k](rng, 4096).tobytes()
             for k in ("zero", "text", "random")]
    short = gen.make(CONFIG["mix"], 4096, rng)[:3000].tobytes()
    return kinds + [short, b""]


def _frozen(units, control=False):
    return [frozen.compress("xpress", u, control=control) for u in units]


def test_the_port_the_reference_and_the_data_agree():
    units = _sets()
    lens = [len(u) for u in units]
    streams = _frozen(units)
    assert ref.decode("xpress", streams, lens) == units
    # the cell's unit width: the far level and the far row at 64 KiB
    assert tt.decompress_batch("xpress", streams, lens,
                               unit_size=CONFIG["unit_bytes"],
                               device="cpu") == units


def test_the_reference_reads_the_ports_streams():
    units = _sets()
    streams = tt.compress_batch("xpress", units, unit_size=4096,
                                device="cpu")
    assert ref.decode("xpress", streams, [len(u) for u in units]) == units


def _text(n):
    return gen.KINDS["text"](gen.rng_for(0x7E5, 2), n).tobytes()


@pytest.mark.parametrize("case", ["truncated", "match-before-the-unit"])
def test_a_malformed_stream_is_refused_by_both(case):
    if case == "truncated":
        unit = _text(500)
        stream = _frozen([unit])[0]
        stream, n = stream[:len(stream) // 2], len(unit)
    else:
        # a flag word whose first bit is a match, then a token of offset
        # 1 at the unit's first byte
        stream, n = b"\x00\x00\x00\x80\x00\x00", 3
    with pytest.raises(ValueError):
        ref.decode("xpress", [stream], [n])
    with pytest.raises(DataError):
        tt.decompress_batch("xpress", [stream], [n], device="cpu")


def _hash3(v):
    """The frozen encoder's hash of 3 bytes (little-endian in ``v``)."""
    return ((v * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - 14)


def test_the_control_breaks_lossless_on_a_hash_collision():
    a = int.from_bytes(b"abc", "little")
    cand = np.arange(1 << 16, dtype=np.int64) | (ord("x") << 16)
    b = int(cand[(_hash3(cand) == _hash3(a)) & (cand != a)][0])
    unit = a.to_bytes(3, "little") + b.to_bytes(3, "little")
    good = _frozen([unit])[0]
    bad = _frozen([unit], control=True)[0]
    assert ref.decode("xpress", [good], [6]) == [unit]
    got = ref.decode("xpress", [bad], [6])
    assert got != [unit] and got == [unit[:3] * 2]


def test_the_reference_agrees_with_the_ports_c_decoder_on_mutants():
    """Bytes flipped in a frozen stream: the reference refuses a mutant
    where the port's native C decoder does, and else gives its bytes."""
    unit = _text(300) + bytes(200)
    stream = _frozen([unit])[0]
    rng = np.random.default_rng(0x7E5)
    refused = 0
    for _ in range(120):
        m = bytearray(stream)
        for at in rng.integers(0, len(m), int(rng.integers(1, 4))):
            m[at] ^= 1 << int(rng.integers(8))
        m = bytes(m)
        try:
            want = tt.decompress("xpress", m, len(unit), backend="cpu")
        except DataError:
            want = None
        try:
            got = ref.decode("xpress", [m], [len(unit)])[0]
        except ValueError:
            got = None
        assert got == want
        refused += got is None
    assert 0 < refused < 120

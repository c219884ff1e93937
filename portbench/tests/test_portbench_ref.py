"""The plain reference reads back what the frozen encoder makes, agrees
with the frozen C decoder, and its block-copy control does not."""

import os

import numpy as np
import pytest

from portbench import frozen, ref, spec
from portbench.data import gen


def _data(kind, n=1 << 16, seed=3):
    return gen.KINDS[kind](gen.rng_for(seed), n).tobytes()


@pytest.mark.parametrize("kind", sorted(gen.KINDS))
def test_lznt1_reads_back_the_frozen_stream(kind):
    data = _data(kind, 3 * 4096 + 123)
    stream = frozen.lznt1_compress(data)
    assert ref.lznt1.decode(stream) == data
    assert frozen.lznt1_decompress(stream, len(data) + 4096) == data


@pytest.mark.parametrize("kind", sorted(gen.KINDS))
def test_xpress_huff_reads_back_the_frozen_stream(kind):
    units = [_data(kind, 8192, s) for s in range(3)] + [_data(kind, 100)]
    streams = [frozen.xh_compress(u) for u in units]
    assert ref.decode("xpress_huff", streams, [len(u) for u in units]) == units
    assert [frozen.xh_decompress(s, len(u))
            for s, u in zip(streams, units)] == units


def test_lznt1_units_decode_joined_and_cut_back():
    units = [_data("text", 65536, s) for s in range(3)]
    streams = [frozen.lznt1_compress(u) for u in units]
    assert ref.decode("lznt1", streams, [len(u) for u in units]) == units


def test_a_mix_reads_back():
    mix = spec.config("ntfs-lznt1")["mix"]
    data = gen.make(mix, 8 * 65536, gen.rng_for(4)).tobytes()
    assert ref.lznt1.decode(frozen.lznt1_compress(data)) == data


@pytest.mark.parametrize("fmt", ["lznt1", "xpress_huff"])
def test_block_copies_break_overlapping_matches(fmt):
    data = (b"ab" * 3000 + _data("text", 6000))[:8192]
    enc = frozen.lznt1_compress if fmt == "lznt1" else frozen.xh_compress
    got = ref.decode(fmt, [enc(data)], [len(data)], block_copies=True)
    assert got != [data]


def test_malformed_streams_raise_value_error():
    data = _data("text", 8192)
    stream = frozen.lznt1_compress(data)
    with pytest.raises(ValueError):
        ref.lznt1.decode(stream[:len(stream) // 2])
    table = bytes([0x11]) * 256 + bytes(64)  # 512 codes of 1 bit
    with pytest.raises(ValueError):
        ref.decode("xpress_huff", [table], [100])
    # a match reaching before the unit's start
    with pytest.raises(ValueError):
        ref.lznt1.decode(bytes([0x02, 0xB0, 0x01, 0x00, 0x10]))


def test_the_control_encoder_breaks_lossless():
    data = _data("records", 65536)
    stream = frozen.lznt1_compress(data, control=True)
    try:
        assert ref.lznt1.decode(stream) != data
    except ValueError:
        pass


@pytest.mark.parametrize("name", ["xh_set_a", "xh_set_b"])
def test_the_sets_the_port_rejects_are_sound(name):
    # two 64 KiB compression sets of hiberfil-xh pages that tpucomp_torch's
    # decompress_batch and decompress reject as malformed, on the card and
    # on the CPU, as tpucomp does; the frozen C decoder and the reference
    # decode both
    data_dir = os.path.join(os.path.dirname(__file__), "data")
    with open(os.path.join(data_dir, name + ".stream"), "rb") as f:
        stream = f.read()
    with open(os.path.join(data_dir, name + ".data"), "rb") as f:
        data = f.read()
    assert frozen.xh_compress(data) == stream
    assert frozen.xh_decompress(stream, len(data)) == data
    assert ref.decode("xpress_huff", [stream], [len(data)]) == [data]

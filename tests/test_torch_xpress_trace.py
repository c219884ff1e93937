"""The spans and counters of the port's plain Xpress batch calls
(``tpucomp_torch/codecs/xpress.py``) on the CPU: a decode's stages,
copies and syncs in order with the bytes they move, an encode's three
compute steps, and nothing recorded without a profiler."""

import functools

import numpy as np
import pytest

import tpucomp_torch as tt
from tpucomp_torch import stats
from tpucomp_torch.codecs import xpress as xp
from _spans import totals, traced

UNIT = 1024  # rows of 1 KiB keep the plain parse short


@functools.lru_cache(maxsize=None)
def _units():
    r = np.random.default_rng(26)
    words = [b"pagefile ", b"hiberfil ", b"kernel ", b"\x00" * 12, b"\n"]
    text = b"".join(words[k] for k in r.integers(0, len(words), 200))
    units = [text[:700], text[100:100 + UNIT], bytes(UNIT // 2)]
    streams = tt.compress_batch("xpress", units, unit_size=UNIT,
                                device="cpu")
    return units, streams


def _children(records, i):
    return [r.name for r in records if r.parent == i]


def test_a_decode_is_one_request_with_its_stages_in_order():
    units, streams = _units()
    lens = [len(u) for u in units]
    out, records = traced(lambda: tt.decompress_batch(
        "xpress", streams, lens, unit_size=UNIT, device="cpu"))
    assert out == units
    assert [(r.name, r.kind) for r in records] == [
        ("api.decompress_batch", "call"), ("xp.pack_units", "stage"),
        ("copy.h2d", "copy"), ("copy.h2d", "copy"), ("copy.h2d", "copy"),
        ("xp.decode", "compute"), ("sync.xp_err", "sync"),
        ("sync.xp_output", "sync"), ("xp.split_output", "stage")]
    assert _children(records, 0) == [
        "xp.pack_units", "xp.decode", "sync.xp_err", "sync.xp_output",
        "xp.split_output"]
    assert _children(records, 1) == ["copy.h2d"] * 3
    for r in records:
        assert records[0].start_ns <= r.start_ns <= r.end_ns <= (
            records[0].end_ns)
    n = totals(records)
    N, P = len(streams), -(-max(map(len, streams)) // 16) * 16
    # the payload rows, their lengths and the decoded lengths (int32)
    assert n["h2d_bytes"] == N * P + 4 * N + 4 * N
    assert n["d2h_bytes"] == N * UNIT  # the decoded rows, uint8
    assert n["xp.units"] == N
    assert n["bytes_in"] == sum(map(len, streams))
    assert n["bytes_out"] == sum(lens)


def test_an_encode_has_its_three_compute_steps():
    units, streams = _units()
    out, records = traced(lambda: tt.compress_batch(
        "xpress", units, unit_size=UNIT, device="cpu"))
    assert out == streams
    assert _children(records, 0) == [
        "util.unit_rows", "xp.find_matches", "xp.greedy_commit",
        "xp.assemble_payload", "util.row_streams"]
    assert {r.kind for r in records if r.name.startswith("xp.")} == {
        "compute"}
    n = totals(records)
    assert n["xp.units"] == len(units)
    assert n["h2d_bytes"] == len(units) * UNIT + 4 * len(units)
    assert n["d2h_bytes"] == len(units) * (xp.max_payload(UNIT) + 4)


class _Refused:
    def __init__(self, *args, **kwargs):
        raise AssertionError("a record function was entered")


@pytest.mark.parametrize("call", ["decompress_batch", "compress_batch"])
def test_off_records_nothing(call, monkeypatch):
    units, streams = _units()
    monkeypatch.setattr(stats, "_RecordFunctionFast", _Refused)
    stats.clear()
    if call == "decompress_batch":
        assert tt.decompress_batch("xpress", streams,
                                   [len(u) for u in units], unit_size=UNIT,
                                   device="cpu") == units
    else:
        assert tt.compress_batch("xpress", units, unit_size=UNIT,
                                 device="cpu") == streams
    assert stats.spans() == [] and stats.dropped == 0

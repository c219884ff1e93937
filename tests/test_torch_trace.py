"""The port's spans and counters (``tpucomp_torch.stats``) on the CPU: off
without a profiler session, the records of the benchmarked paths under
one, their clock against the profiler's own trace, the counters, threads
kept apart, and the cap on a thread's records."""

import functools
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpucomp_torch as tt
from tpucomp_torch import stats
from tpucomp_torch.codecs import lznt1 as lz
from tpucomp_torch.kernels import huffman
from _spans import names, totals, traced
from _threads import _one_thread  # noqa: F401

UNIT = 1024  # XH rows of 1 KiB keep the plain walk short


def _text(n: int, seed: int) -> bytes:
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"epsilon ", b"\n"]
    r = np.random.default_rng(seed)
    out = b"".join(words[k] for k in r.integers(0, len(words), n // 4))
    return out[:n]


@functools.lru_cache(maxsize=None)
def _lznt1(seed: int = 1):
    data = _text(9000, seed) + bytes(np.random.default_rng(seed).integers(
        0, 256, 700, dtype=np.uint8))
    return data, tt.compress("lznt1", data, backend="oracle")


@functools.lru_cache(maxsize=None)
def _xh():
    units = [_text(700, 2), _text(UNIT, 3)]
    streams = tt.compress_batch("xpress_huff", units, unit_size=UNIT,
                                device="cpu")
    return units, streams


def _calls():
    """The benchmarked paths' calls, each with its result's check."""
    data, stream = _lznt1()
    units, streams = _xh()
    return {
        "lznt1.decompress": (
            lambda: tt.decompress("lznt1", stream, device="cpu"),
            lambda out: out == data),
        "lznt1.compress": (
            lambda: tt.compress("lznt1", data[:5000], device="cpu"),
            lambda out: tt.decompress("lznt1", out, backend="oracle")
            == data[:5000]),
        "xh.compress_batch": (
            lambda: tt.compress_batch("xpress_huff", units, unit_size=UNIT,
                                      device="cpu"),
            lambda out: out == streams),
        "xh.decompress_batch": (
            lambda: tt.decompress_batch("xpress_huff", streams,
                                        [len(u) for u in units],
                                        unit_size=UNIT, device="cpu"),
            lambda out: out == units),
    }


# each call's root and its children, in order
TREES = {
    "lznt1.decompress": ("api.decompress", [
        "lznt1.split_stream", "lznt1.pack_chunks", "lznt1.decode",
        "sync.lznt1_err", "lznt1.joined_output"]),
    "lznt1.compress": ("api.compress", [
        "lznt1.split_chunks", "copy.h2d", "copy.h2d", "lznt1.find_matches",
        "lznt1.greedy_commit", "lznt1.assemble_payload",
        "sync.lznt1_payload", "sync.lznt1_plen", "lznt1.frame_chunks"]),
    "xh.compress_batch": ("api.compress_batch", [
        "util.unit_rows", "xh.find_matches", "xh.greedy_commit",
        "xh.symbols", "xh.code_tables", "xh.lookup", "xh.assemble_payload",
        "util.row_streams"]),
    "xh.decompress_batch": ("api.decompress_batch", [
        "xh.pack_units", "xh.decode", "sync.xh_err", "sync.xh_output",
        "xh.split_output"]),
}


def _children(records, i):
    return [r.name for r in records if r.parent == i]


class _Refused:
    def __init__(self, *args, **kwargs):
        raise AssertionError("a record function was entered")


@pytest.mark.parametrize("path", ["lznt1", "xh"])
def test_off_records_nothing_and_enters_no_record_function(path,
                                                            monkeypatch):
    monkeypatch.setattr(stats, "_RecordFunctionFast", _Refused)
    stats.clear()
    if path == "lznt1":
        data, stream = _lznt1()
        assert tt.decompress("lznt1", stream, device="cpu") == data
        assert tt.decompress("lznt1", tt.compress("lznt1", data[:3000],
                                                  device="cpu"),
                             device="cpu") == data[:3000]
    else:
        units, streams = _xh()
        assert tt.compress_batch("xpress_huff", units, unit_size=UNIT,
                                 device="cpu") == streams
        assert tt.decompress_batch("xpress_huff", streams,
                                   [len(u) for u in units], unit_size=UNIT,
                                   device="cpu") == units
    assert stats.spans() == [] and stats.dropped == 0


@pytest.mark.parametrize("call", list(TREES))
def test_on_a_call_is_one_request_with_its_stages_in_order(call):
    run, ok = _calls()[call]
    out, records = traced(run)
    assert ok(out), out
    root, children = TREES[call]
    roots = [i for i, r in enumerate(records) if r.parent is None]
    assert len(roots) == 1
    top = records[roots[0]]
    assert (top.name, top.kind) == (root, "call")
    assert isinstance(top.request, int)
    assert _children(records, roots[0]) == children
    assert all(r.kind in stats.KINDS for r in records)
    assert {r.request for r in records} == {top.request}
    assert {r.thread for r in records} == {threading.get_native_id()}
    for r in records:
        assert top.start_ns <= r.start_ns <= r.end_ns <= top.end_ns
    n = totals(records)
    assert n["bytes_out"] == (len(out) if isinstance(out, bytes)
                              else sum(map(len, out)))
    # every host-card copy and sync of the call is a span of its kind
    assert names(records, "copy") == {"copy.h2d"}
    assert all(r.name.startswith("sync.") for r in records
               if r.kind == "sync")
    assert n["h2d_bytes"] > 0 and n["d2h_bytes"] > 0


@pytest.mark.parametrize("call", ["lznt1.decompress", "xh.compress_batch"])
def test_spans_are_on_the_profilers_clock(call, tmp_path):
    run, ok = _calls()[call]
    stats.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert ok(run())
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    ops = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "cpu_op":
            ops.setdefault((e["name"], e["tid"]), []).append(
                e["ts"] * 1000 + base)
    records = stats.spans()
    assert records
    mine = {}
    for r in records:
        mine.setdefault((r.name, r.thread), []).append(r.start_ns)
    for key, starts in mine.items():
        theirs = sorted(ops.get(key, []))
        assert len(theirs) == len(starts), key
        for a, b in zip(sorted(starts), theirs):
            assert abs(a - b) < 1e6, (key, a, b)


def test_counters_of_an_lznt1_read():
    data, stream = _lznt1()
    out, records = traced(
        lambda: tt.decompress("lznt1", stream, device="cpu"))
    assert out == data
    payloads, comps = lz.split_stream(stream)
    n = totals(records)
    N = len(payloads)
    assert n["lznt1.chunks"] == N
    assert n["lznt1.chunks_compressed"] == sum(comps)
    # the payload rows, their lengths (int32) and flags (bool)
    assert n["h2d_bytes"] == N * lz.PAYLOAD_PAD + 4 * N + N
    assert n["d2h_bytes"] == len(data)
    assert n["bytes_in"] == len(stream) and n["bytes_out"] == len(data)


def test_counters_of_the_xh_batches():
    units, streams = _xh()
    lens = [len(u) for u in units]
    _, enc = traced(lambda: tt.compress_batch(
        "xpress_huff", units, unit_size=UNIT, device="cpu"))
    n = totals(enc)
    assert n["xh.units"] == len(units)
    assert n["h2d_bytes"] == len(units) * UNIT + 4 * len(units)
    assert n["bytes_in"] == sum(lens)
    assert n["bytes_out"] == sum(map(len, streams))
    assert n["huffman.merge_steps"] == sum(
        r.name == "huffman.merge_step" for r in enc)
    _, dec = traced(lambda: tt.decompress_batch(
        "xpress_huff", streams, lens, unit_size=UNIT, device="cpu"))
    n = totals(dec)
    assert n["xh.units"] == len(units) and n["xh.batch_decodes"] == 1
    assert n["d2h_bytes"] >= len(units) * UNIT


def _fib_freqs():
    """Two rows of symbol counts: one of 5 and one of 9 used symbols, and
    one of 24 Fibonacci counts, whose tree is deeper than 15."""
    f = torch.zeros((3, huffman.NUM_SYMBOLS), dtype=torch.int32)
    f[0, [3, 70, 71, 300, 511]] = torch.tensor([5, 1, 9, 2, 2],
                                               dtype=torch.int32)
    f[1, 10:19] = torch.arange(1, 10, dtype=torch.int32)
    fib = [1, 1]
    while len(fib) < 24:
        fib.append(fib[-1] + fib[-2])
    f[2, 100:124] = torch.tensor(fib, dtype=torch.int32)
    return f


@pytest.mark.parametrize("rows,deep", [([0], False), ([0, 1], False),
                                       ([0, 1, 2], True)])
def test_merge_steps_and_repair_rounds(rows, deep):
    freqs = _fib_freqs()[rows]

    def call():
        with stats.span("test.call", "call"):
            return huffman.huffman_code_lengths(freqs)

    lengths, records = traced(call)
    n_used = (freqs > 0).sum(1)
    n = totals(records)
    assert n["huffman.merge_steps"] == int(n_used.max()) - 1
    assert n["huffman.merge_steps"] == sum(
        r.name == "huffman.merge_step" for r in records)
    assert n["huffman.repair_rounds"] == sum(
        r.name == "huffman.repair_round" for r in records)
    assert (n["huffman.repair_rounds"] > 0) == deep
    assert int(lengths.max()) <= huffman.MAX_CODE_LEN
    assert torch.equal(lengths, huffman.huffman_code_lengths(freqs))


def test_huffman_tables_on_the_cpu_counts_the_plain_steps():
    """On CPU tensors ``huffman_tables`` runs the plain version: its merge
    steps and repair rounds are counted as above, and no kernel row."""
    freqs = _fib_freqs()

    def call():
        with stats.span("test.call", "call"):
            return huffman.huffman_tables(freqs)

    (lengths, _), records = traced(call)
    n = totals(records)
    assert n["huffman.merge_steps"] == int((freqs > 0).sum(1).max()) - 1
    assert n["huffman.repair_rounds"] > 0
    assert "huffman.kernel_rows" not in n
    assert "launches.huffman_tables" not in n
    assert torch.equal(lengths, huffman.huffman_code_lengths(freqs))


def test_two_threads_keep_their_requests_apart():
    inputs = [_lznt1(1), _lznt1(2)]
    got = [None, None]
    start = threading.Barrier(2)

    def client(k):
        start.wait()
        got[k] = (threading.get_native_id(),
                  tt.decompress("lznt1", inputs[k][1], device="cpu"))

    stats.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    records = stats.spans()
    roots = [r for r in records if r.parent is None]
    assert sorted(r.name for r in roots) == ["api.decompress"] * 2
    assert roots[0].request != roots[1].request
    for k, (tid, out) in enumerate(got):
        assert out == inputs[k][0]
        root = next(r for r in roots if r.thread == tid)
        mine = [r for r in records if r.request == root.request]
        assert {r.thread for r in mine} == {tid}
        n = totals(mine)
        assert n["bytes_out"] == len(inputs[k][0])
        assert n["lznt1.chunks"] == len(lz.split_stream(inputs[k][1])[0])


def test_a_threads_records_are_capped_and_the_rest_counted(monkeypatch):
    _, stream = _lznt1()
    _, full = traced(lambda: tt.decompress("lznt1", stream, device="cpu"))
    monkeypatch.setattr(stats, "MAX_RECORDS", 4)
    traced(lambda: tt.decompress("lznt1", stream, device="cpu"))
    records = stats.spans()
    assert [r.name for r in records] == [r.name for r in full[:4]]
    assert stats.dropped == len(full) - 4
    stats.clear()
    assert stats.spans() == [] and stats.dropped == 0


def test_launches_count_on_the_wrapper_and_the_open_request():
    def wrapper():
        pass

    wrapper.launches = 0
    stats.clear()
    stats.launched(wrapper)
    assert wrapper.launches == 1 and stats.spans() == []

    def call():
        with stats.span("test.call", "call"):
            stats.launched(wrapper, 2)

    _, records = traced(call)
    assert wrapper.launches == 3
    assert totals(records) == {"launches.wrapper": 2}


def test_threads_lose_no_launch_and_share_no_request():
    """More threads than cores, switching often: every launch counted on
    the wrapper and on its own request, and no two requests alike."""
    import os
    import sys

    def wrapper():
        pass

    wrapper.launches = 0
    workers, calls = 2 * (os.cpu_count() or 4), 200
    kept = sys.getswitchinterval()
    stats.clear()
    sys.setswitchinterval(1e-6)
    try:
        def client():
            for _ in range(calls):
                with stats.span("test.call", "call"):
                    stats.launched(wrapper)

        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=client)
                       for _ in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(kept)
    records = stats.spans()
    assert wrapper.launches == workers * calls
    assert len(records) == workers * calls
    assert len({r.request for r in records}) == workers * calls
    assert all(r.counters == {"launches.wrapper": 1} for r in records)

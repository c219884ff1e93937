"""The readers of the program's own span records
(``tpucomp_torch.stats.spans()``) on hand-made records: the division by
the traced calls' root spans, self time with nested children, the copy
rate against the trace's copy time, and ``None`` where there is nothing
to read."""

from types import SimpleNamespace

import pytest

from portbench import spec


def _read(metric, **ctx):
    return spec.reader(metric)(SimpleNamespace(**ctx))


def _rec(name, kind, ms, parent, request, **counters):
    """A span record of the program's (``tpucomp_torch.stats.spans()``)
    over ``ms``, a (start, end) pair of milliseconds."""
    return SimpleNamespace(name=name, kind=kind, thread=1,
                           start_ns=int(ms[0] * 1e6), end_ns=int(ms[1] * 1e6),
                           parent=parent, request=request, counters=counters)


def _program_records():
    """Two traced calls, requests 1 and 2, and a span of request 3 opened
    outside any API call (left out)."""
    return [
        _rec("api.compress_batch", "call", (0, 100), None, 1),
        _rec("util.unit_rows", "stage", (0, 20), 0, 1),
        _rec("copy.h2d", "copy", (10, 15), 1, 1, h2d_bytes=1000),
        _rec("xh.code_tables", "compute", (20, 60), 0, 1,
             **{"huffman.merge_steps": 3, "huffman.repair_rounds": 1}),
        _rec("huffman.merge_step", "compute", (25, 30), 3, 1),
        _rec("sync.huffman_steps", "sync", (20, 22), 3, 1),
        _rec("util.row_streams", "stage", (60, 100), 0, 1),
        _rec("sync.row_payload", "sync", (60, 90), 6, 1, d2h_bytes=3000),
        _rec("api.decompress", "call", (200, 240), None, 2),
        _rec("lznt1.split_stream", "stage", (200, 210), 8, 2),
        _rec("sync.lznt1_err", "sync", (210, 212), 8, 2),
        _rec("lznt1.decode", "compute", (300, 400), None, 3, h2d_bytes=7),
    ]


PROGRAM_READERS = {
    # stage self time: unit_rows 20 - 5, row_streams 40 - 30, split 10
    "staging_ms_per_call.write": 35.0 / 2,
    # compute self time: code_tables 40 - 5 - 2, merge_step 5
    "launch_ms_per_call.read": 38.0 / 2,
    "sync_wait_ms_per_call.write": 34.0 / 2,
    "syncs_per_call.read": 3 / 2,
    # 4000 bytes over the calls' 2 us of copies
    "copy_GBps.write": 4000 / 2e-6 / 1e9,
    "merge_steps_per_call.write": (3 + 1) / 2,
}


def _program_ctx():
    return dict(trace={"calls": [{"copy_s": 1e-6}, {"copy_s": 1e-6}]})


@pytest.mark.parametrize("metric", sorted(PROGRAM_READERS))
def test_program_span_readers(metric, monkeypatch):
    from tpucomp_torch import stats

    recs = _program_records()
    monkeypatch.setattr(stats, "spans", lambda: recs)
    assert _read(metric, **_program_ctx()) == pytest.approx(
        PROGRAM_READERS[metric])
    # no traced run, no record, no API call among the records
    assert _read(metric, trace=None) is None
    monkeypatch.setattr(stats, "spans", lambda: [])
    assert _read(metric, **_program_ctx()) is None
    monkeypatch.setattr(stats, "spans", lambda: recs[-1:])
    assert _read(metric, **_program_ctx()) is None
    # a program that keeps no records
    monkeypatch.delattr(stats, "spans")
    assert _read(metric, **_program_ctx()) is None


def test_program_counter_readers_without_their_counters(monkeypatch):
    from tpucomp_torch import stats

    recs = [_rec("api.compress", "call", (0, 10), None, 1)]
    monkeypatch.setattr(stats, "spans", lambda: recs)
    assert _read("merge_steps_per_call.write", **_program_ctx()) is None
    assert _read("copy_GBps.read", **_program_ctx()) is None
    assert _read("syncs_per_call.write", **_program_ctx()) == 0.0
    ctx = dict(trace={"calls": [{"copy_s": 0.0}]})
    recs[0].counters["h2d_bytes"] = 5
    assert _read("copy_GBps.read", **ctx) is None

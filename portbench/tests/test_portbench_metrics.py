"""The metric arithmetic on hand-made records: the trace's reduction (the
union of two clients' device records, the idle share, each call's host
and copy time) and the readers."""

import math
from types import SimpleNamespace

import pytest

from portbench import spec, trace


def _ann(name, ts, dur, tid):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": tid}


def _launch(corr, ts, tid):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "tid": tid, "args": {"correlation": corr}}


def _dev(cat, name, corr, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 7, "args": {"correlation": corr}}


def _events():
    """A window of 100 us; client 0 (thread 1) runs one call over 0-60 us
    with a kernel at 10-30 and a copy at 40-50; client 1 (thread 2) one
    call over 20-90 with a kernel at 25-45."""
    return [
        _ann(trace.WINDOW, 0, 100, 9),
        _ann(trace.CALL + "0", 0, 60, 1),
        _ann(trace.CALL + "1", 20, 70, 2),
        _launch(1, 5, 1), _dev("kernel", "void k1(int)", 1, 10, 20),
        _launch(2, 35, 1), _dev("gpu_memcpy",
                                "Memcpy DtoH (Device -> Pageable)", 2, 40, 10),
        _launch(3, 22, 2), _dev("kernel", "void k2<int>(int)", 3, 25, 20),
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 21,
         "dur": 3, "tid": 2},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 50,
         "dur": 40, "tid": 2},
    ]


def test_the_reduction_unions_clients_on_one_clock():
    s = trace.summarize(_events(), {0: [(1000, 10)], 1: [(2000, 20)]})
    # device busy: 10-45 and 40-50 -> 10-50 = 40 us of 100
    assert s["busy_s"] == pytest.approx(40e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    c0, c1 = s["calls"]
    assert c0["span_s"] == pytest.approx(60e-6)
    assert c0["host_s"] == pytest.approx(30e-6)   # 60 less 20 and 10
    assert c0["copy_s"] == pytest.approx(10e-6)
    assert c0["kernel_s"] == pytest.approx(20e-6)
    assert c0["launches"] == 1 and c1["launches"] == 1
    assert c1["host_s"] == pytest.approx(50e-6)   # 70 less 20
    assert (c0["decoded"], c1["encoded"]) == (1000, 20)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["k2 [aten::add]"] == pytest.approx(20e-6)
    gaps = dict(s["breakdown"]["idle_gaps"])
    # idle: 0-10 (client 0's call alone) and 50-100 (client 1 in
    # aten::copy_ at the middle, 75; client 0's call has ended)
    assert gaps["portbench.call (no aten op)"] == pytest.approx(10e-6)
    assert gaps["aten::copy_"] == pytest.approx(50e-6)


def test_a_trace_without_the_calls_is_refused():
    with pytest.raises(RuntimeError):
        trace.summarize(_events(), {0: [(1, 1)], 1: [(1, 1), (1, 1)]})


def test_lost_launches_after_the_primer():
    ev = [_ann(trace.PRIMER, 0, 10, 1), _launch(1, 5, 1),
          _launch(2, 20, 1), _launch(3, 30, 1),
          _dev("kernel", "k", 2, 21, 1)]
    assert [e["args"]["correlation"] for e in trace.lost_launches(ev)] == [3]


def _read(metric, **ctx):
    return spec.reader(metric)(SimpleNamespace(**ctx))


def test_trace_readers():
    s = trace.summarize(_events(), {0: [(1000, 10)], 1: [(2000, 20)]})
    ctx = dict(trace=s, device_kind="NVIDIA H100 80GB HBM3")
    assert _read("device_idle_pct.read", **ctx) == pytest.approx(60.0)
    assert _read("host_ms_per_call.read", **ctx) == pytest.approx(0.040)
    assert _read("copy_ms_per_call.write", **ctx) == pytest.approx(0.005)
    assert _read("launches_per_call.read", **ctx) == 1.0
    # 3030 bytes at 3.35 TB/s over 40 us of kernels
    assert _read("device_roofline.read", **ctx) == pytest.approx(
        100 * 3030 / 3.35e12 / 40e-6)
    assert _read("device_roofline.read", trace=s, device_kind="a CPU") is None


def _calls(lat_ms, ok=None):
    ok = ok or [True] * len(lat_ms)
    return [SimpleNamespace(start=0.0, end=ms / 1e3, ok=k, decoded=10**9,
                            encoded=5 * 10**8) for ms, k in zip(lat_ms, ok)]


def test_window_readers():
    calls = _calls(list(range(1, 101)))
    ctx = dict(direction="read", seconds=4.0, calls=calls, trace=None)
    assert _read("decode_GBps", **ctx) == pytest.approx(25.0)
    assert _read("read_p95_ms", **ctx) == pytest.approx(95.0)
    assert _read("encode_GBps", **ctx) is None
    failed = _calls(list(range(1, 101)), [True] * 90 + [False] * 10)
    ctx["calls"] = failed
    assert _read("read_p95_ms", **ctx) is None      # falls on a failure
    assert _read("decode_GBps", **ctx) == pytest.approx(22.5)
    ctx["calls"] = _calls([1.0] * 20, [True] * 19 + [False])
    assert math.isclose(_read("read_p95_ms", **ctx), 1.0)
    w = dict(direction="write", seconds=2.0, calls=_calls([5.0] * 4),
             trace=None, pool_bytes=(30, 120), setup_s=1.5)
    assert _read("encode_GBps", **w) == pytest.approx(2.0)
    assert _read("encode_ratio_pct", **w) == pytest.approx(25.0)
    assert _read("setup_s", **w) == 1.5

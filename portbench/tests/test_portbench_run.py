"""Whole runs on the CPU at tiny sizes: the rehearsal of the run path
through the real program, the refusal of a run that finds no card, the
faults planted under the timed path that the check has to catch, and
each cell's control."""

import json
import os
import subprocess
import sys
import threading

import pytest

from portbench import control, frozen, harness, ref, spec

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = os.path.join(HERE, "cells", "ntfs-lznt1.tiny.json")
BENCH = spec.benchmark()
CHECK = ["calls_failed", "answers_wrong", "bytes_wrong", "answers_checked"]


def _tiny():
    with open(TINY) as f:
        return json.load(f)


def _run(cell, seconds=2.0, traced=False, device="cpu", call=None,
         name="ntfs-lznt1.read"):
    e2e, layer = spec.cell_metrics(BENCH, name)
    return harness.run(cell, spec.config(cell["config"]), e2e, layer, 5,
                       seconds, traced, device=device, call=call)


def test_cpu_rehearsal_of_the_run_path():
    result = _run(_tiny())
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {"decode_GBps", "read_p95_ms", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert line["device"]["count"] == 1
    assert set(line["check"]) == set(CHECK + ["inputs_wrong"])


def test_without_a_card_the_command_fails_and_prints_no_result():
    repo = os.path.dirname(spec.ROOT)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=repo, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


# a stand-in for the program, fast on the CPU: the frozen encoder (one
# caller at a time: it keeps static scratch) and the reference decoder,
# each called as the API entry would be
_ONE_AT_A_TIME = threading.Lock()


def _encode(fmt, data):
    with _ONE_AT_A_TIME:
        return frozen.compress(fmt, data)


def _stand_in(api, fmt):
    if api == "compress":
        return lambda x: _encode(fmt, x["arg"])
    if api == "compress_batch":
        return lambda x: [_encode(fmt, u) for u in x["arg"]]
    if api == "decompress":
        return lambda x: ref.decode(fmt, [x["arg"]], [len(x["expect"])])[0]
    return lambda x: ref.decode(fmt, *x["arg"])


def _unchanged(api, fmt):
    return lambda x: x["arg"][0] if api == "decompress_batch" else x["arg"]


def _half(api, fmt):
    good = _stand_in(api, fmt)
    return lambda x: (lambda out: out[:len(out) // 2])(good(x))


def _altered(api, fmt):
    good = _stand_in(api, fmt)

    def flip(b):
        b = bytearray(b)
        b[len(b) // 2] ^= 0x5A
        return bytes(b)

    def call(x):
        out = good(x)
        return flip(out) if isinstance(out, bytes) else [flip(o) for o in out]
    return call


def _small(name, units=3, unit_bytes=4096):
    cell = dict(spec.cell(name), pool=2, trace_calls=2, check_units=2,
                check_share=1.0)
    if "units" in cell["call"]:
        cell["call"] = {"units": {"count": units, "bytes": unit_bytes,
                                  "short": [1024]}}
    else:
        cell["call"] = {"file_bytes": 2 * 65536}
    return cell


CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_the_stand_in_passes(name):
    cell = _small(name)
    fmt = spec.config(cell["config"])["format"]
    result = _run(cell, 1.0, call=_stand_in(cell["api"], fmt), name=name)
    assert result["correct"] is True, result["check"]


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state-unchanged", "half-the-batch",
                              "answer-altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault):
    cell = _small(name)
    fmt = spec.config(cell["config"])["format"]
    result = _run(cell, 1.0, call=fault(cell["api"], fmt), name=name)
    assert result["correct"] is False
    assert result["check"]["answers_wrong"]["value"] > 0 or (
        result["check"]["calls_failed"]["value"] > 0)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = _small(name, units=4, unit_bytes=16384)
    config = spec.config(cell["config"])
    for seed in (1, 2, 3):
        numbers = control.one(config, cell, seed, 0)
        assert numbers["answers_checked"] >= 1
        assert numbers["answers_wrong"] > 0 and numbers["bytes_wrong"] > 0


@pytest.mark.cuda
def test_tiny_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    result = _run(_tiny(), device="cuda")
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    traced = _run(_tiny(), traced=True, device="cuda")
    assert traced["correct"] is True
    assert traced["device"]["busy_s"] > 0
    assert set(traced["metrics"]) == {
        m["name"] for m in spec.cell_metrics(BENCH, "ntfs-lznt1.read")[1]}

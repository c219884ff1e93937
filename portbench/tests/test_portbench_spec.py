"""``BENCHMARK.json`` and the files it names: allowed names and units,
the keys each entry has, every cell's configuration and metrics, and
parts added as files that the harness finds by name."""

import json
import os
import re
import shutil

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(spec.BENCHMARK) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    assert all(TEXT.match(w) for w in BENCH["command"])


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries_names_and_units(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert set(e) - {"workloads"} == KEYS[group], e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                              "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert TEXT.match(e[key]), (e["name"], key)
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_layers_name_the_same_layer_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(TEXT.match(layer) for layer in layers)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_loads_and_names_what_exists(w):
    cell = spec.cell(w["name"])
    config = spec.config(cell["config"])
    assert cell["name"] == w["name"] and w["config"] == cell["config"]
    assert w["why"] == cell["why"] and w["chips"] == 1
    assert config["name"] == cell["config"]
    assert cell["api"] in ("compress", "decompress", "compress_batch",
                           "decompress_batch")
    e2e, layer = spec.cell_metrics(BENCH, w["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in e2e + layer:
        spec.reader(m["name"])
        assert m["moves"] in names if "moves" in m else True


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_has_its_file(c):
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    config = spec.config(c["name"])
    assert config["source"] == c["source"]
    assert config["reduced"] == c["reduced"] == []
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert set(config["guarantees"]) >= {"lossless", "bit_exact_decode"}


def test_parts_added_as_files_are_found_by_name(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(spec.ROOT, root,
                    ignore=shutil.ignore_patterns(".build", "__pycache__"))
    cfg = json.loads((root / "configs" / "ntfs-lznt1.json").read_text())
    cfg.update(name="ntfs-lznt1-8k", unit_bytes=8192)
    (root / "configs" / "ntfs-lznt1-8k.json").write_text(json.dumps(cfg))
    cell = spec.cell("ntfs-lznt1.read")
    cell.update(name="ntfs-lznt1-8k.read", config="ntfs-lznt1-8k")
    (root / "cells" / "ntfs-lznt1-8k.read.json").write_text(
        json.dumps(cell))
    (root / "metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n    return len(ctx.calls) / ctx.seconds\n")
    assert spec.config("ntfs-lznt1-8k", str(root))["unit_bytes"] == 8192
    assert spec.cell("ntfs-lznt1-8k.read", str(root))["config"] == (
        "ntfs-lznt1-8k")

    class Ctx:
        calls, seconds = [1, 2, 3], 2.0
    assert spec.reader("calls_per_s.read", str(root))(Ctx) == 1.5
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "calls_per_s.read", "unit": "1/s", "better": "higher",
         "source": "program_counter", "layer": "device", "moves":
         "decode_GBps", "workloads": ["ntfs-lznt1-8k.read"]}])
    _, layer = spec.cell_metrics(bench, "ntfs-lznt1-8k.read")
    assert [m["name"] for m in layer] == ["calls_per_s.read"]
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric", str(root))

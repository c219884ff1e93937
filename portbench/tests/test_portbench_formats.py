"""A format the benchmark has never seen is added by files alone.

A toy format is planted in a temporary root of the benchmark: a stream
is records of a 4-byte little-endian length followed by that many bytes.
It comes as ``ref/toy.py`` and ``frozen/toy.c`` (exporting
``toy_compress``, which honours ``PORTBENCH_CONTROL``), beside
``frozen/bare.c``, whose ``bare_compress`` does not.  A configuration
and a cell of each API entry then run through the harness's own lookup
by name: the inputs, the check, the control and a whole run on the CPU.
"""

import json
import os
import shutil
import threading

import pytest

from portbench import control, frozen, harness, inputs, ref, spec

REF = '''"""The toy format's reference: records of a 4-byte little-endian
length and that many bytes; ``block_copies`` (the control) drops each
record's last byte."""


def decode_units(streams, out_lens, block_copies=False):
    out = []
    for s in streams:
        at, parts = 0, []
        while at < len(s):
            if at + 4 > len(s):
                raise ValueError("toy: length cut short")
            n = int.from_bytes(s[at:at + 4], "little")
            if at + 4 + n > len(s):
                raise ValueError("toy: record past the end")
            parts.append(s[at + 4:at + 4 + n - (block_copies and n > 0)])
            at += 4 + n
        out.append(b"".join(parts))
    return out
'''

TOY_C = r'''/* The toy format: one record of a 4-byte little-endian length and the
 * bytes.  Built with -DPORTBENCH_CONTROL, the last byte is altered. */
#include <stdint.h>
#include <string.h>

int toy_compress(const uint8_t *in, int n, uint8_t *out, int cap) {
    if (n + 4 > cap) return -3;
    for (int i = 0; i < 4; i++) out[i] = (uint8_t)(n >> (8 * i));
    memcpy(out + 4, in, (size_t)n);
#ifdef PORTBENCH_CONTROL
    if (n > 0) out[3 + n] ^= 0x5A;
#endif
    return n + 4;
}
'''

BARE_C = r'''#include <stdint.h>
#include <string.h>

int bare_compress(const uint8_t *in, int n, uint8_t *out, int cap) {
    if (n > cap) return -3;
    memcpy(out, in, (size_t)n);
    return n;
}
'''

CONFIG = {
    "name": "toy-deployment", "format": "toy", "unit_bytes": 4096,
    "self_terminating": True,
    # a toy stream is 4 bytes longer than its unit: keep every unit
    "stored_raw_unless_saves": -4,
    "mix": {"page": 4096, "max_run": 2,
            "shares": {"text": 0.5, "records": 0.3, "random": 0.2}},
}
APIS = ["compress", "compress_batch", "decompress", "decompress_batch"]


def _cell(api):
    call = ({"units": {"count": 3, "bytes": 4096, "short": [1000]}}
            if api.endswith("_batch") else {"file_bytes": 3 * 4096})
    return {"name": f"toy-deployment.{api}", "config": "toy-deployment",
            "api": api, "clients": 1, "pool": 2, "call": call,
            "check_share": 1.0, "check_units": 2, "trace_calls": 2,
            "why": "the planted toy format"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    for name, text in (("ref/toy.py", REF), ("frozen/toy.c", TOY_C),
                       ("frozen/bare.c", BARE_C)):
        os.makedirs(os.path.dirname(os.path.join(root, name)),
                    exist_ok=True)
        with open(os.path.join(root, name), "w") as f:
            f.write(text)
    shutil.copytree(os.path.join(spec.ROOT, "metrics"),
                    os.path.join(root, "metrics"))
    return root


_ONE_AT_A_TIME = threading.Lock()


def _stand_in(api, root):
    """The program's call, played by the toy's frozen encoder and
    reference, each found by the format's name under ``root``."""
    def encode(data):
        with _ONE_AT_A_TIME:
            return frozen.compress("toy", data, root=root)
    if api == "compress":
        return lambda x: encode(x["arg"])
    if api == "compress_batch":
        return lambda x: [encode(u) for u in x["arg"]]
    if api == "decompress":
        return lambda x: ref.decode("toy", [x["arg"]], [len(x["expect"])],
                                    root=root)[0]
    return lambda x: ref.decode("toy", *x["arg"], root=root)


def _drop_a_byte(api, root):
    good = _stand_in(api, root)

    def call(x):
        out = good(x)
        return out[1:] if isinstance(out, bytes) else [out[0][1:], *out[1:]]
    return call


def _run(api, root, call):
    name = "ntfs-lznt1." + ("write" if api in inputs.WRITES else "read")
    e2e, layer = spec.cell_metrics(spec.benchmark(), name)
    return harness.run(_cell(api), CONFIG, e2e, layer, 7, 0.5, False,
                       device="cpu", call=call(api, root), root=root)


@pytest.mark.parametrize("api", APIS)
def test_inputs_and_check_find_the_format_by_name(api, root):
    cell = _cell(api)
    x = inputs.make(CONFIG, cell, 3, 0, root)
    if api in inputs.READS:
        assert all(s[4:] == u for s, u in zip(x["streams"], x["units"]))
        out = _stand_in(api, root)(x)
        assert out == x["expect"]
    else:
        out = _stand_in(api, root)(x)
    tally = harness.check(CONFIG, cell, 3, [x], [(0, out)], root)
    assert tally.checked >= 1 and tally.wrong == tally.bytes == 0
    assert tally.inputs_wrong == 0


@pytest.mark.parametrize("api", APIS)
def test_the_control_is_found_by_name_and_fails(api, root):
    cell = _cell(api)
    x = inputs.make(CONFIG, cell, 4, 1, root)
    out = control.control_output(CONFIG, cell, x, root)
    tally = harness.check(CONFIG, cell, 4, [x], [(0, out)], root)
    assert tally.checked >= 1 and tally.wrong > 0 and tally.bytes > 0
    numbers = control.one(CONFIG, cell, 4, 1, root)
    assert numbers["answers_wrong"] == tally.wrong


@pytest.mark.parametrize("api", APIS)
def test_a_whole_run_is_correct_and_a_dropped_byte_is_not(api, root):
    result = _run(api, root, _stand_in)
    assert result["correct"] is True, result["check"]
    assert result["attempted"] >= 1 and result["metrics"]["setup_s"]
    line = json.loads(json.dumps(result))
    assert line["check"]["answers_checked"]["value"] >= 1
    result = _run(api, root, _drop_a_byte)
    assert result["correct"] is False
    assert result["check"]["answers_wrong"]["value"] > 0


def test_an_unknown_format_is_refused_by_name(root):
    for fmt in ("nosuch", "../ref/toy", "Toy"):
        with pytest.raises(ValueError, match="no reference decoder for "
                                             "format"):
            ref.decode(fmt, [b""], [0], root=root)
    with pytest.raises(ValueError, match=r"nosuch_compress.*frozen/bare\.c, "
                                         r"frozen/toy\.c"):
        frozen.compress("nosuch", b"abc", root=root)
    with pytest.raises(ValueError, match="no frozen encoder"):
        frozen.compress("../toy", b"abc", root=root)
    read = dict(CONFIG, format="nosuch")
    with pytest.raises(ValueError, match="nosuch_compress"):
        inputs.make(read, _cell("decompress_batch"), 3, 0, root)
    # a write of a format with no reference reads back as wrong
    x = inputs.make(read, _cell("compress"), 3, 0, root)
    tally = harness.check(read, _cell("compress"), 3, [x],
                          [(0, frozen.compress("toy", x["arg"], root=root))],
                          root)
    assert tally.wrong == tally.checked == 1


def test_a_source_that_ignores_the_control_has_none(root):
    data = b"abcdefgh" * 100
    assert frozen.compress("bare", data, root=root) == data
    with pytest.raises(ValueError, match=r"'bare'.*frozen/bare\.c.*"
                                         r"PORTBENCH_CONTROL"):
        frozen.compress("bare", data, control=True, root=root)
    assert frozen.compress("toy", data, control=True, root=root) != (
        frozen.compress("toy", data, root=root))


def test_the_benchmark_finds_its_own_formats_by_name():
    data = b"portbench " * 1000
    for fmt in {spec.config(w["config"])["format"]
                for w in spec.benchmark()["workloads"]}:
        stream = frozen.compress(fmt, data)
        assert ref.decode(fmt, [stream], [len(data)]) == [data]
        assert ref.module(fmt) is getattr(ref, fmt)
    assert frozen.compress("xpress_huff", data) == frozen.xh_compress(data)

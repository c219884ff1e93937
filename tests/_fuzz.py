"""Shared pieces of the differential mutation checks of the decoders
(``tests/test_torch_fuzz_*.py``).

Each mutant of ``tests/_mutate.py`` goes through, in both packages:

A. the device path on the CPU: tpucomp's XLA path and the port's plain
   versions (``device="cpu"``), batched in calls of one shape, compared
   row by row (err on every row; out_len and bytes where err is 0), and
   on a sample the one-shot ``decompress`` (the same bytes or the same
   error class);
B. the host backends: the native C codec and the oracle, the port's
   copies against tpucomp's;
C. within each package, the device path against the native C decoder
   and the oracle: a disagreement must be one of ``_mutate.CLASSES``.

A record is one mutant's dict: ``op``, ``index``, ``seed``, ``stream``,
``out_len``, ``outcomes`` (side -> ("ok", bytes) or (exception class
name,)), ``row_faults`` (its batch rows where the packages differ),
``classes`` and ``tp_classes`` (C in the port and in tpucomp).
"""

from __future__ import annotations

import collections

import numpy as np

import _mutate

OK = "ok"
# the outcome of tpucomp's XH native decoder where it is not called: on an
# over-subscribed table it fills its lookup table past its end
NOT_CALLED = ("not called: tpucomp's native C writes past its table",)
# the pairs of sides that must agree: A (device) and B (host backends)
A_PAIRS = (("port_device", "tp_device"),)
B_PAIRS = (("port_native", "tp_native"), ("port_oracle", "tp_oracle"))


def outcome(fn, *args, **kw):
    try:
        return (OK, bytes(fn(*args, **kw)))
    except Exception as e:  # noqa: BLE001 - the class is the outcome
        return (type(e).__name__,)


def pad_rows(n: int, multiple: int) -> int:
    """Rows of a batch call: ``n`` rounded up to ``multiple``."""
    return max(multiple, -(-n // multiple) * multiple)


def np_rows(rows, width: int) -> np.ndarray:
    """Byte strings -> int32 [len(rows), width], zero padded."""
    out = np.zeros((len(rows), width), np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = np.frombuffer(r, np.uint8)
    return out


def chunked(n: int, size: int):
    """(start, stop) of the calls of ``size`` rows that cover ``n``."""
    return [(a, min(a + size, n)) for a in range(0, max(n, 1), size)]


def record(fmt, m) -> dict:
    return {"fmt": fmt, "op": m.op, "index": m.index, "seed": m.seed,
            "stream": m.stream, "out_len": m.out_len, "outcomes": {},
            "row_faults": 0, "classes": [], "tp_classes": []}


def host_outcomes(r, port_native, tp_native, port_oracle, tp_oracle,
                  native_safe=lambda r: True):
    """B: each host backend of each package on the record's stream."""
    args = (r["stream"], r["out_len"])
    o = r["outcomes"]
    o["port_native"] = outcome(port_native, *args)
    o["tp_native"] = (outcome(tp_native, *args) if native_safe(r)
                      else NOT_CALLED)
    o["port_oracle"] = outcome(port_oracle, *args)
    o["tp_oracle"] = outcome(tp_oracle, *args)


def classify(r) -> None:
    """C in each package, from the record's outcomes."""
    o, fmt = r["outcomes"], r["fmt"]
    unit = r.get("unit_size")
    r["classes"] = _mutate.classify(fmt, r["stream"], r["out_len"], {
        "device": o["port_device"], "native": o["port_native"],
        "oracle": o["port_oracle"]}, unit)
    tp = {"device": o["tp_device"], "oracle": o["tp_oracle"]}
    if o["tp_native"] != NOT_CALLED:
        tp["native"] = o["tp_native"]
    r["tp_classes"] = _mutate.classify(fmt, r["stream"], r["out_len"], tp,
                                       unit)


def hint(r) -> str:
    """How to rebuild a record's mutant."""
    return (f"{r['fmt']} seed {r['seed']} index {r['index']} op "
            f"{r['op']!r}: _mutate.mutant({r['fmt']!r}, sources, "
            f"{r['seed']}, {r['index']}, {r['op']!r})")


def _show(out) -> str:
    return out[0] if out[0] != OK else f"ok, {len(out[1])} bytes"


def faults(records, pairs) -> list:
    """Messages for the records whose sides of ``pairs`` differ."""
    msgs = []
    for r in records:
        o = r["outcomes"]
        for a, b in pairs:
            if o[b] == NOT_CALLED or o[a] == o[b]:
                continue
            msgs.append(f"{a} {_show(o[a])} != {b} {_show(o[b])}: "
                        + hint(r))
    return msgs


def row_faults(records) -> list:
    return [f"{r['row_faults']} batch rows differ: " + hint(r)
            for r in records if r["row_faults"]]


def unlisted(records) -> list:
    msgs = []
    for r in records:
        for key, label in (("classes", "port"), ("tp_classes", "tpucomp")):
            if _mutate.UNLISTED in r[key]:
                o = r["outcomes"]
                msgs.append(f"{label}: an unlisted disagreement ("
                            + ", ".join(f"{k} {_show(v)}"
                                        for k, v in o.items()) + "): "
                            + hint(r))
    return msgs


def not_called_only_on_err_table(records, port_rc) -> list:
    """tpucomp's native decoder is skipped only where the port's returns
    ERR_TABLE (``port_rc(record)``)."""
    return [hint(r) for r in records
            if r["outcomes"].get("tp_native") == NOT_CALLED
            and port_rc(r) != -5]


def summary(label: str, records) -> str:
    """One line: mutants, each side's rejects, the classes met."""
    rej = collections.Counter()
    classes = collections.Counter()
    for r in records:
        for side, out in r["outcomes"].items():
            rej[side] += out[0] != OK
        for c in r["classes"]:
            classes[c] += 1
    return (f"{label}: {len(records)} mutants; rejects "
            + ", ".join(f"{k} {v}" for k, v in sorted(rej.items()))
            + "; classes (port) " + (", ".join(
                f"{k} {v}" for k, v in sorted(classes.items())) or "none"))


def check(records) -> None:
    """A, B and C over ``records``: raise with every fault found."""
    msgs = (row_faults(records) + faults(records, A_PAIRS)
            + faults(records, B_PAIRS) + unlisted(records))
    assert not msgs, f"{len(msgs)} faults:\n" + "\n".join(msgs[:20])

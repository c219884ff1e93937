"""Differential mutation check of the plain Xpress decoders on the CPU.

Seeded mutants of valid plain Xpress unit streams and their decoded
lengths (``tests/_mutate.py``) go through (see ``tests/_fuzz.py``):

A. the device path of both packages: every mutant a row of one batch at
   unit width U (tpucomp's jitted decoder on its XLA path, the port's
   ``codecs.xpress.decode_batch`` on the plain versions), err on every
   row and the bytes where err is 0; a stream longer than
   ``max_payload(U)`` goes through ``decompress_units`` instead, where
   tpucomp fails with numpy's ValueError and the port raises DataError
   (ROADMAP.md queue 3, the one stated exception).  On a sample, the
   one-shot ``decompress`` of both packages;
B. ``backend="cpu"`` (the native C decoder) and ``backend="oracle"``, the
   port's copies against tpucomp's;
C. in each package, the device path against the native C decoder and
   the oracle: every disagreement is ``xpress-u32-escape-wrap`` or
   ``xpress-unit-past-capacity``.

Tier-1 runs 12 mutants an operator (8 operators) at U = 4096; ``-m
slow`` runs 1250 (10,000) at U = 8192.  The plain parse loops once per
payload byte, so the units stay at 1-8 KiB.  Every value is a byte or an
integer: equality is exact.
"""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest

import _fuzz as F
import _mutate as M
from conftest import make_corpus
from tpucomp import _native as t_native
from tpucomp.codecs import xpress as t_xp
from tpucomp.oracle import xpress as t_oracle
from tpucomp_torch import _native as p_native
from tpucomp_torch.codecs import xpress as xp
from tpucomp_torch.oracle import xpress as p_oracle
from _threads import _one_thread  # noqa: F401

FMT = "xpress"
OPS = M.OPERATORS[FMT]
TIER1 = dict(per_op=12, seed=20261020, sample=1, U=4096)
SLOW = dict(per_op=1250, seed=20261021, sample=4, U=8192)
CALL_ROWS = 1024  # rows of a batch call of the slow run
ROW_MULTIPLE = 128
# the stated exception: a unit stream longer than the unit's largest
# encoding (tpucomp: numpy's broadcast ValueError; the port: DataError)
TOO_LONG = (("DataError",), ("ValueError",))


@functools.lru_cache(maxsize=None)
def sources(U: int):
    """(stream, out_len) valid unit streams of at most U bytes: corpus
    units, random bytes, runs and an empty unit, by the native C and the
    oracle encoders."""
    rng = random.Random(U)
    units = [make_corpus(rng, n) for n in
             (U // 4, U // 2, U - 700, U - 64, U - 1000, U // 3)]
    units += [bytes(rng.randrange(256) for _ in range(U // 2)),
              b"ab" * (U // 4), b"z" * (U - 100), b""]
    return ([(p_native.xpress_compress(u), len(u)) for u in units]
            + [(p_oracle.compress(u), len(u)) for u in units[:5]])


def _decode_rows(streams, out_lens, U, calls):
    """Both packages' batch decode at width U, in calls of ``calls``
    rows of one shape.  Returns each package's (out, err)."""
    n = len(streams)
    N = F.pad_rows(n, calls)
    P = -(-max(16, max(map(len, streams))) // 64) * 64
    payload = F.np_rows(list(streams) + [b""] * (N - n), P)
    plen = np.array([len(s) for s in streams] + [0] * (N - n), np.int32)
    olen = np.array(list(out_lens) + [0] * (N - n), np.int32)
    port, tp = [], []
    for a, b in F.chunked(N, calls):
        args = (payload[a:b], plen[a:b], olen[a:b])
        port.append([t.numpy() for t in xp.decode_batch(
            *xp.batch_from_numpy(*args, device="cpu"), U)])
        tp.append([np.asarray(t) for t in t_xp._dec_for(U)(
            *(jnp.asarray(x) for x in args))])
    return ([np.concatenate(p)[:n] for p in zip(*port)],
            [np.concatenate(p)[:n] for p in zip(*tp)])


def _units_call(decompress_units, s, n, U, **kw):
    return decompress_units([s], [n], U, **kw)[0]


@functools.lru_cache(maxsize=None)
def run(per_op: int, seed: int, sample: int, U: int):
    mutants = M.mutants(FMT, sources(U), per_op * len(OPS), seed, out_cap=U)
    records = [F.record(FMT, m) for m in mutants]
    for r in records:
        r["unit_size"] = U
    cap = xp.max_payload(U)
    rows = [i for i, r in enumerate(records) if len(r["stream"]) <= cap]
    calls = CALL_ROWS if len(rows) > CALL_ROWS else ROW_MULTIPLE
    (out, err), (t_out, t_err) = _decode_rows(
        [records[i]["stream"] for i in rows],
        [records[i]["out_len"] for i in rows], U, calls)
    for k, i in enumerate(rows):
        r, n = records[i], records[i]["out_len"]
        r["row_faults"] = int(err[k] != t_err[k]
                              or (not err[k] and (out[k] != t_out[k]).any()))
        for side, oo, ee in (("port_device", out, err),
                             ("tp_device", t_out, t_err)):
            r["outcomes"][side] = (("DataError",) if ee[k] else
                                   (F.OK, oo[k, :n].astype(np.uint8)
                                    .tobytes()))
    for r in records:
        o = r["outcomes"]
        if "port_device" not in o:  # longer than the unit's largest stream
            o["port_device"] = F.outcome(_units_call, xp.decompress_units,
                                         r["stream"], r["out_len"], U,
                                         device="cpu")
            o["tp_device"] = F.outcome(_units_call, t_xp.decompress_units,
                                       r["stream"], r["out_len"], U)
            r["too_long"] = True
        F.host_outcomes(r, p_native.xpress_decompress,
                        t_native.xpress_decompress, p_oracle.decompress,
                        t_oracle.decompress)
        F.classify(r)
    for op in OPS:
        for r in [r for r in records if r["op"] == op][:sample]:
            r["oneshot"] = (
                F.outcome(lambda s, n: xp.decompress(s, n, device="cpu"),
                          r["stream"], r["out_len"]),
                F.outcome(t_xp.decompress, r["stream"], r["out_len"]))
    return records


def of_op(records, op):
    return [r for r in records if r["op"] == op]


def device_faults(records) -> list:
    """A: the batch rows, each mutant's outcome, the one-shot calls; the
    stated exception apart."""
    msgs = F.row_faults(records)
    for r in records:
        o = r["outcomes"]
        pair = (o["port_device"], o["tp_device"])
        if pair[0] != pair[1] and not (r.get("too_long")
                                       and pair == TOO_LONG):
            msgs.append(f"device {pair[0][0]} != tpucomp {pair[1][0]}: "
                        + F.hint(r))
        if "oneshot" in r:
            got, want = r["oneshot"]
            unit = min(u for u in (4096, 16384, 65536) if r["out_len"] <= u)
            stated = (len(r["stream"]) > xp.max_payload(unit)
                      and (got, want) == TOO_LONG)
            if got != want and not stated:
                msgs.append(f"one-shot {got[0]} != tpucomp {want[0]}: "
                            + F.hint(r))
    return msgs


# ---- tier-1: each operator --------------------------------------------------

@pytest.mark.parametrize("op", OPS)
def test_device_path_equals_tpucomp(op):
    recs = of_op(run(**TIER1), op)
    assert len(recs) == TIER1["per_op"]
    msgs = device_faults(recs)
    assert not msgs, "\n".join(msgs)
    assert sum("oneshot" in r for r in recs) == TIER1["sample"]


@pytest.mark.parametrize("op", OPS)
def test_host_backends_equal_tpucomp(op):
    recs = of_op(run(**TIER1), op)
    msgs = F.faults(recs, F.B_PAIRS)
    assert not msgs, "\n".join(msgs)


@pytest.mark.parametrize("op", OPS)
def test_disagreements_are_listed_classes(op):
    recs = of_op(run(**TIER1), op)
    msgs = F.unlisted(recs)
    assert not msgs, "\n".join(msgs)


def test_mutants_are_accepted_and_rejected():
    """The check is not vacuous: each side accepts some mutants and
    rejects others."""
    recs = run(**TIER1)
    print(F.summary("xpress tier-1", recs))
    for side in ("port_device", "port_native", "port_oracle"):
        oks = [r["outcomes"][side][0] == F.OK for r in recs]
        assert 0.2 < np.mean(oks) < 0.9, side


# ---- the pinned case of the class -------------------------------------------

def _wrap_stream(value: int) -> bytes:
    """Three literals "abc", then a match of offset 3 whose length takes
    the u32 escape with ``value``, then literals: a flag word of 32 bits
    (bit 31 first: literals, then the match at bit 28)."""
    flags = 1 << 28
    token = ((3 - 1) << 3) | 7  # offset 3, length bits 7
    esc = b"\x0f" + b"\xff" + b"\x00\x00" + value.to_bytes(4, "little")
    return (flags.to_bytes(4, "little") + b"abc" + token.to_bytes(2, "little")
            + esc + b"d" * 27)


def test_u32_escape_wrap_pinned():
    """``xpress-u32-escape-wrap``: a u32 length escape of 2^31 - 3 or
    more.  The device parse's int32 position wraps (tpucomp
    ``xp_pallas.py:107, 143``, ``codecs/xpress.py:181, 218``; the port's
    parse reproduces its XLA scan) and so does the native C; the oracle's
    Python integers do not.  Each side rejects this stream here, so the
    class shows no disagreement on its outcomes; it stays listed for
    streams where a wrapped length lands inside ``out_len``.  [MS-XCA]
    §2.4.4 reads the escape as an unsigned 32-bit length: a length past
    the output is an error, the oracle's reading; the fix of the device
    parse and the native C belongs to both packages at once."""
    for value in (2 ** 31 - 3, 2 ** 32 - 1):
        s = _wrap_stream(value)
        assert M.xpress_walk(s)["wrap"]
        for decode in (lambda s, n: xp.decompress(s, n, device="cpu"),
                       t_xp.decompress, p_native.xpress_decompress,
                       p_oracle.decompress):
            with pytest.raises(Exception) as e:
                decode(s, 40)
            assert type(e.value).__name__ == "DataError"
    # the same escape with the match's true length decodes everywhere
    s = _wrap_stream(40 - 3 - 3)
    want = p_oracle.decompress(s, 40)
    assert want == b"abc" * 13 + b"a"
    assert xp.decompress(s, 40, device="cpu") == t_xp.decompress(s, 40) \
        == p_native.xpress_decompress(s, 40) == want


def test_unit_past_capacity_pinned():
    """``xpress-unit-past-capacity``: a unit of 4096 random bytes (every
    byte a literal: 4612 bytes of stream) with 64 bytes appended, past
    ``max_payload(4096)`` = 4616.  The device paths refuse it, the port
    with DataError and tpucomp with numpy's ValueError (ROADMAP.md queue
    3); the native C and the oracle decode its 4096 bytes and leave the
    rest, as every decoder of the repo leaves bytes past out_len.
    [MS-XCA] §2.4.4 sets no length on a stream: the host codecs are
    right, and the device path's bound is its row width, a stated limit
    of both packages' batch decoders."""
    unit = np.random.default_rng(4).integers(0, 256, 4096, np.uint8).tobytes()
    s = p_native.xpress_compress(unit) + bytes(range(64))
    assert len(s) > xp.max_payload(4096) == 4616
    outs = {"device": F.outcome(_units_call, xp.decompress_units, s, 4096,
                                4096, device="cpu"),
            "native": F.outcome(p_native.xpress_decompress, s, 4096),
            "oracle": F.outcome(p_oracle.decompress, s, 4096)}
    assert outs["device"] == ("DataError",)
    assert F.outcome(_units_call, t_xp.decompress_units, s, 4096, 4096) == \
        ("ValueError",)
    assert outs["native"] == outs["oracle"] == (F.OK, unit)
    assert M.classify(FMT, s, 4096, outs, 4096) == \
        ["xpress-unit-past-capacity"]
    assert M.classify(FMT, s, 4096, outs) == [M.UNLISTED]


# ---- under -m slow: at least 10^4 mutants -----------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("op", OPS)
def test_slow_each_operator(op):
    recs = of_op(run(**SLOW), op)
    assert len(recs) == SLOW["per_op"]
    msgs = device_faults(recs) + F.faults(recs, F.B_PAIRS) + F.unlisted(recs)
    assert not msgs, "\n".join(msgs[:20])


@pytest.mark.slow
def test_slow_ten_thousand_mutants():
    recs = run(**SLOW)
    assert len(recs) >= 10_000
    msgs = device_faults(recs) + F.faults(recs, F.B_PAIRS) + F.unlisted(recs)
    assert not msgs, "\n".join(msgs[:20])
    print(F.summary("xpress slow", recs))

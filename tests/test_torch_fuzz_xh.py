"""Differential mutation check of the Xpress Huffman (XH) decoders on the
CPU.

Seeded mutants of valid XH streams and their decoded lengths
(``tests/_mutate.py``) go through (see ``tests/_fuzz.py``):

A. the device path of both packages: every one-block mutant a row of one
   batch at unit width U (tpucomp's jitted decoder on its XLA path, at
   its widest substep tier in tier-1, a call per tier as its
   ``decompress_units`` buckets them in the slow run; the port's
   ``codecs.xpress_huff.decode_batch`` on the plain versions, each row's
   own tier an input), err on every row and the bytes where err is 0;
   the port's tail also with ``fast_resolve``, equal to without.  A
   stream longer than ``max_payload(U)`` goes through
   ``decompress_units`` instead, where tpucomp fails with numpy's
   ValueError and the port raises DataError (ROADMAP.md queue 3).  On a
   sample, the one-shot ``decompress`` of both packages, and of mutants
   of two-block streams (the multi-block path);
B. ``backend="cpu"`` (the native C decoder) and ``backend="oracle"``, the
   port's copies against tpucomp's.  tpucomp's native decoder is not
   called on a stream whose over-subscribed table the port's copy
   rejects with ERR_TABLE: tpucomp's fills its lookup table past its end
   there (ROADMAP.md queue 3);
C. in each package, the device path against the native C decoder and
   the oracle: every disagreement is ``xh-oversubscribed-table``,
   ``xh-reads-past-end`` or ``xh-u32-escape-wrap``.

Tier-1 runs 6 mutants an operator (12 operators) at U = 2048, one
through the one-shot call; ``-m slow`` runs 834 (10,008) at U = 8192, 24
through the one-shot call, and 24 two-block mutants.  The plain parse loops once per body byte, so the units stay
small.  Every value is a byte or an integer: equality is
exact.
"""

import ctypes
import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest

import _fuzz as F
import _mutate as M
from conftest import make_corpus
from tpucomp import _native as t_native
from tpucomp.codecs import xpress_huff as t_xh
from tpucomp.oracle import xpress_huff as t_oracle
from tpucomp_torch import _native as p_native
from tpucomp_torch.codecs import xpress_huff as xh
from tpucomp_torch.errors import DataError
from tpucomp_torch.oracle import xpress_huff as p_oracle
from _threads import _one_thread  # noqa: F401

FMT = "xpress_huff"
OPS = M.OPERATORS[FMT]
# tpucomp's decoder at one substep tier for every row (its widest, 17:
# one compile) in tier-1, bucketed by each row's tier in the slow run
TIER1 = dict(per_op=6, seed=20261022, U=2048, multi=0, tp_tier=17,
             sample=(("escape15",), 1))
SLOW = dict(per_op=834, seed=20261023, U=8192, multi=24, tp_tier=None,
            sample=(OPS, 2))
CALL_ROWS = 1024  # rows of a batch call of the slow run
ROW_MULTIPLE = 64
MULTI_OPS = ("block_edge", "table_nibbles", "kraft_over", "escape15",
             "flip_bits", "truncate", "out_len")
TOO_LONG = (("DataError",), ("ValueError",))
SHAPES = {}  # (U, rows a call) -> the payload width of the run's calls


@functools.lru_cache(maxsize=None)
def sources(U: int):
    """(stream, out_len) valid one-block streams of at most U bytes:
    corpus units, random bytes, runs and an empty unit, by the native C
    and the oracle encoders."""
    rng = random.Random(U + 1)
    units = [make_corpus(rng, n) for n in
             (U // 4, U // 2, U - 700, U - 64, U - 1000, U // 3)]
    units += [bytes(rng.randrange(256) for _ in range(U // 2)),
              b"ab" * (U // 4), b"z" * (U - 100), b""]
    return ([(p_native.xh_compress(u), len(u)) for u in units]
            + [(p_oracle.compress(u), len(u)) for u in units[:5]])


@functools.lru_cache(maxsize=None)
def multi_sources():
    """Two-block streams: 64 KiB of repeated text (a short first body, so
    the plain parse stays quick) and 2000 more bytes, by the native C
    and the oracle encoders."""
    rng = random.Random(2)
    data = (make_corpus(rng, 700) * 100)[:65536] + make_corpus(rng, 2000)
    return [(p_native.xh_compress(data), len(data)),
            (p_oracle.compress(data), len(data))]


def port_rc(r) -> int:
    """The port's native C decoder's status on a record's stream."""
    n = r["out_len"]
    out = ctypes.create_string_buffer(max(n, 1))
    return p_native._load().xh_decompress(r["stream"], len(r["stream"]),
                                          out, n)


def _decode_rows(streams, out_lens, U, calls, tp_tier):
    """Both packages' batch decode at width U, in calls of ``calls`` rows
    of one shape: the port's rows each at its own substep tier,
    tpucomp's at ``tp_tier`` or, where None, a call per tier as its
    ``decompress_units`` buckets them (a tier above a row's own decodes
    it the same: more substeps a refill than its codes can use).
    Returns the port's (out, err), its err with ``fast_resolve`` and the
    differences of its bytes there, and tpucomp's (out, err)."""
    n = len(streams)
    P = -(-max(256, max(map(len, streams))) // 64) * 64
    SHAPES[U, calls] = P
    payload = F.np_rows(streams, P)
    plen = np.array([len(s) for s in streams], np.int32)
    olen = np.array(out_lens, np.int32)
    ss = np.array([xh._substeps_for(xh._min_code_len([s]))
                   for s in streams], np.int32)
    out = np.zeros((n, U), np.uint8)
    err = np.zeros(n, bool)
    fast_bad = np.zeros(n, bool)
    N = F.pad_rows(n, calls)
    pad = np.arange(N) % n
    for a, b in F.chunked(N, calls):
        idx = pad[a:b]
        batch = xh.batch_from_numpy(payload[idx], plen[idx], olen[idx],
                                    ss[idx], device="cpu")
        parsed = xh.parse_batch(*batch, U)
        o, e = xh._records_to_output(*parsed, batch[2], U)
        of, ef = xh._records_to_output(*parsed, batch[2], U,
                                       fast_resolve=True)
        keep = slice(0, max(0, min(b, n) - a))
        out[idx[keep]] = o.numpy()[keep]
        err[idx[keep]] = e.numpy()[keep]
        fast_bad[idx[keep]] = ((ef != e) | (~e & (of != o).any(1))).numpy()[
            keep]
    t_out = np.zeros((n, U), np.int32)
    t_err = np.zeros(n, bool)
    t_ss = ss if tp_tier is None else np.full(n, tp_tier, np.int32)
    for tier in sorted(set(t_ss.tolist())):
        rows = np.flatnonzero(t_ss == tier)
        M_ = F.pad_rows(len(rows), calls)
        sel = rows[np.arange(M_) % len(rows)]
        for a, b in F.chunked(M_, calls):
            keep = slice(0, max(0, min(b, len(rows)) - a))
            o, e = t_xh._dec_for(U, int(tier))(
                jnp.asarray(payload[sel[a:b]]), jnp.asarray(plen[sel[a:b]]),
                jnp.asarray(olen[sel[a:b]]))
            t_out[sel[a:b][keep]] = np.asarray(o)[keep]
            t_err[sel[a:b][keep]] = np.asarray(e)[keep]
    return (out, err), fast_bad, (t_out, t_err)


def _units_call(decompress_units, s, n, U, **kw):
    return decompress_units([s], [n], U, **kw)[0]


def _hosts(r):
    F.host_outcomes(r, p_native.xh_decompress, t_native.xh_decompress,
                    p_oracle.decompress, t_oracle.decompress,
                    native_safe=lambda r: port_rc(r) != p_native.ERR_TABLE)
    F.classify(r)


@functools.lru_cache(maxsize=None)
def run(per_op: int, seed: int, sample: tuple, U: int, multi: int,
        tp_tier):
    mutants = M.mutants(FMT, sources(U), per_op * len(OPS), seed, out_cap=U)
    records = [F.record(FMT, m) for m in mutants]
    for r in records:
        r["unit_size"] = U
    cap = xh.max_payload(U)
    rows = [i for i, r in enumerate(records) if len(r["stream"]) <= cap]
    calls = CALL_ROWS if len(rows) > CALL_ROWS else ROW_MULTIPLE
    (out, err), fast_bad, (t_out, t_err) = _decode_rows(
        [records[i]["stream"] for i in rows],
        [records[i]["out_len"] for i in rows], U, calls, tp_tier)
    for k, i in enumerate(rows):
        r, n = records[i], records[i]["out_len"]
        r["row_faults"] = int(err[k] != t_err[k] or fast_bad[k]
                              or (not err[k] and (out[k] != t_out[k]).any()))
        for side, oo, ee in (("port_device", out, err),
                             ("tp_device", t_out, t_err)):
            r["outcomes"][side] = (("DataError",) if ee[k] else
                                   (F.OK, oo[k, :n].astype(np.uint8)
                                    .tobytes()))
    for r in records:
        o = r["outcomes"]
        if "port_device" not in o:  # longer than the unit's largest stream
            o["port_device"] = F.outcome(_units_call, xh.decompress_units,
                                         r["stream"], r["out_len"], U,
                                         device="cpu")
            o["tp_device"] = F.outcome(_units_call, t_xh.decompress_units,
                                       r["stream"], r["out_len"], U)
            r["too_long"] = True
        _hosts(r)
    # the one-shot calls: ``sample`` is (operators, mutants of each)
    ops, each = sample
    for op in ops:
        for r in of_op(records, op)[:each]:
            r["oneshot"] = _oneshot(r)
    # two-block streams through the one-shot calls alone
    multi_recs = [F.record(FMT, m) for m in M.mutants(
        FMT, multi_sources(), multi, seed, ops=MULTI_OPS)]
    for r in multi_recs:
        r["oneshot"] = _oneshot(r)
        r["outcomes"]["port_device"], r["outcomes"]["tp_device"] = \
            r["oneshot"]
        _hosts(r)
    return records, multi_recs


def _oneshot(r):
    return (F.outcome(lambda s, n: xh.decompress(s, n, device="cpu"),
                      r["stream"], r["out_len"]),
            F.outcome(t_xh.decompress, r["stream"], r["out_len"]))


def of_op(records, op):
    return [r for r in records if r["op"] == op]


def device_faults(records) -> list:
    """A: the batch rows, each mutant's outcome and the one-shot calls;
    the stated exception apart."""
    msgs = F.row_faults(records)
    for r in records:
        o = r["outcomes"]
        pair = (o["port_device"], o["tp_device"])
        if pair[0] != pair[1] and not (r.get("too_long")
                                       and pair == TOO_LONG):
            msgs.append(f"device {pair[0][0]} != tpucomp {pair[1][0]}: "
                        + F.hint(r))
        if "oneshot" in r and r["oneshot"][0] != r["oneshot"][1]:
            msgs.append(f"one-shot {r['oneshot'][0][0]} != tpucomp "
                        f"{r['oneshot'][1][0]}: " + F.hint(r))
    return msgs


def all_faults(records) -> list:
    return (device_faults(records) + F.faults(records, F.B_PAIRS)
            + F.unlisted(records)
            + F.not_called_only_on_err_table(records, port_rc))


# ---- tier-1: each operator --------------------------------------------------

@pytest.mark.parametrize("op", OPS)
def test_device_path_equals_tpucomp(op):
    recs = of_op(run(**TIER1)[0], op)
    assert len(recs) == TIER1["per_op"]
    msgs = device_faults(recs)
    assert not msgs, "\n".join(msgs)


@pytest.mark.parametrize("op", OPS)
def test_host_backends_equal_tpucomp(op):
    recs = of_op(run(**TIER1)[0], op)
    msgs = (F.faults(recs, F.B_PAIRS)
            + F.not_called_only_on_err_table(recs, port_rc))
    assert not msgs, "\n".join(msgs)


@pytest.mark.parametrize("op", OPS)
def test_disagreements_are_listed_classes(op):
    recs = of_op(run(**TIER1)[0], op)
    msgs = F.unlisted(recs)
    assert not msgs, "\n".join(msgs)


@pytest.mark.slow
def test_slow_multi_block_oneshot():
    """Mutants of two-block streams through the one-shot calls (the
    multi-block path: Kraft candidates, the speculative batch, the chain
    walk), A, B and C.  Slow only: tpucomp's one-shot decoder compiles
    for [N, 131072] rows."""
    recs = run(**SLOW)[1]
    assert len(recs) == SLOW["multi"]
    assert all(len(M.xh_walk(s, n)["blocks"]) == 2
               for s, n in multi_sources())
    msgs = all_faults(recs)
    assert not msgs, "\n".join(msgs)


def test_mutants_are_accepted_and_rejected():
    """The check is not vacuous: each side accepts some mutants and
    rejects others, and the one-shot sample ran."""
    recs = run(**TIER1)[0]
    print(F.summary("xpress_huff tier-1", recs))
    for side in ("port_device", "port_native", "port_oracle"):
        oks = [r["outcomes"][side][0] == F.OK for r in recs]
        assert 0.15 < np.mean(oks) < 0.9, side
    ops, each = TIER1["sample"]
    assert sum("oneshot" in r for r in recs) == len(ops) * each


# ---- the pinned cases of the classes, and the native decoder's fault --------

def _one_block(table_lengths, body: bytes) -> bytes:
    lens = np.zeros(512, np.int64)
    for sym, n in table_lengths.items():
        lens[sym] = n
    return (lens[0::2] | (lens[1::2] << 4)).astype(np.uint8).tobytes() + body


def pinned(rows):
    """The device outcome of hand-built one-block rows (stream, out_len)
    in both packages: one batch of the tier-1 run's shape (U, rows,
    payload width and tpucomp's tier 17), so that tpucomp's decoder
    compiles no more (every pinned table's shortest code is 1 bit: the
    port's tier is 17 too).  Returns [(port outcome, tpucomp
    outcome)]."""
    run(**TIER1)
    U, N = TIER1["U"], ROW_MULTIPLE
    n = len(rows)
    assert n <= N
    rows = list(rows) + [rows[0]] * (N - n)
    payload = F.np_rows([r for r, _ in rows], SHAPES[U, N])
    plen = np.array([len(r) for r, _ in rows], np.int32)
    olen = np.array([o for _, o in rows], np.int32)
    ss = np.array([xh._substeps_for(xh._min_code_len([r])) for r, _ in rows],
                  np.int32)
    assert (ss == 17).all()
    out, err = (t.numpy() for t in xh.decode_batch(*xh.batch_from_numpy(
        payload, plen, olen, ss, device="cpu"), U))
    t_out, t_err = (np.asarray(t) for t in t_xh._dec_for(U, 17)(
        jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(olen)))

    def one(o, e, k):
        return ("DataError",) if e[k] else (
            F.OK, o[k, :olen[k]].astype(np.uint8).tobytes())

    return [(one(out, err, k), one(t_out, t_err, k)) for k in range(n)]


def test_oversubscribed_table_pinned():
    """``xh-oversubscribed-table``: symbols "a" and "b" with 1-bit codes
    and a third symbol with another: Kraft sum 5/4.  Both device paths
    build their tables from the lengths without checking the sum and
    decode (tpucomp ``kernels/huffman.py``, the port's
    ``kernels/huffman.py``: the same canonical tables); the oracle
    rejects ("over-subscribed canonical code lengths"), and so does the
    port's native C (ERR_TABLE), where tpucomp's writes past its
    32768-entry lookup table.  [MS-XCA] §2.2.4 builds the
    decoding table entry by entry and calls the data invalid once an
    entry would lie past the table's end: the host codecs are right; the
    device paths keep tpucomp's behaviour (ROADMAP.md queue 3)."""
    s = _one_block({ord("a"): 1, ord("b"): 1, ord("c"): 2}, bytes(8))
    assert port_rc({"stream": s, "out_len": 8}) == p_native.ERR_TABLE
    with pytest.raises(DataError):
        p_native.xh_decompress(s, 8)
    with pytest.raises(DataError):
        p_oracle.decompress(s, 8)
    with pytest.raises(Exception) as e:
        t_oracle.decompress(s, 8)
    assert type(e.value).__name__ == "DataError"
    [(got, want)] = pinned([(s, 8)])
    assert got == want == (F.OK, b"a" * 8)
    assert M.xh_walk(s, 8)["oversubscribed"]
    assert M.classify(FMT, s, 8, {
        "device": got, "native": ("DataError",),
        "oracle": ("DataError",)}) == ["xh-oversubscribed-table"]


def test_native_rejects_oversubscribed_tables_of_every_shape():
    """The native C XH decoders fill a 32768-entry lookup table from a
    block's code lengths; on an over-subscribed table tpucomp's run past
    its end (a crash, or a write into the codec's other static arrays).
    The port's return ERR_TABLE on every shape of such a table, in the
    one-shot and the stream decoder."""
    shapes = ({0: 1, 1: 1, 2: 1},                          # 3/2
              {s: 1 for s in range(512)},                  # 256
              {**{s: 15 for s in range(300)}, 0: 1, 1: 1},
              {s: 8 for s in range(257)})                  # 257/256
    for lengths in shapes:
        s = _one_block(lengths, bytes(64))
        assert M._decode_table([lengths.get(i, 0) for i in range(512)]) \
            is None
        assert port_rc({"stream": s, "out_len": 100}) == p_native.ERR_TABLE
        d = p_native.NativeStreamDecompressor(FMT, 100)
        with pytest.raises(DataError):
            d.decompress(s)
            d.flush()


# a mutant that runs tpucomp's native C XH decoder past its lookup table:
# (seed, index, operator) of the tier-1 sources at U = 2048 (a splice of
# another stream's body over the table: Kraft sum 27.86)
NATIVE_TABLE_FAULT = (TIER1["seed"], 520, "splice")


def test_native_table_fault_regression():
    """The mutant on which tpucomp's native XH decoder fills its
    32768-entry lookup table far past its end (in a child process it
    ended with SIGSEGV): the port's one-shot and stream decoders reject
    it with ERR_TABLE, as the oracle rejects it; both device paths
    decode it with the same result."""
    seed, index, op = NATIVE_TABLE_FAULT
    U = TIER1["U"]
    m = M.mutant(FMT, sources(U), seed, index, op, out_cap=U)
    assert M.xh_walk(m.stream, m.out_len)["oversubscribed"]
    assert port_rc({"stream": m.stream, "out_len": m.out_len}) == \
        p_native.ERR_TABLE
    with pytest.raises(DataError):
        p_native.xh_decompress(m.stream, m.out_len)
    d = p_native.NativeStreamDecompressor(FMT, m.out_len)
    with pytest.raises(DataError):
        d.decompress(m.stream)
        d.flush()
    with pytest.raises(DataError):
        p_oracle.decompress(m.stream, m.out_len)
    [(got, want)] = pinned([(m.stream, m.out_len)]) \
        if xh._min_code_len([m.stream]) == 1 else [(
            F.outcome(lambda s, n: xh.decompress(s, n, device="cpu"),
                      m.stream, m.out_len),
            F.outcome(t_xh.decompress, m.stream, m.out_len))]
    assert got == want


def test_reads_past_end_pinned():
    """``xh-reads-past-end``: a table with two 1-bit codes ("a" = 0, "b"
    = 1) and a body of two zero words, 32 bits of "a".  The device parse
    decodes a symbol only while 16 bits read from the stream are in its
    window, and stops at the stream's end (tpucomp ``xh_pallas.py``, its
    XLA scan; the port's ``xh_parse``): past the 17th "a" it rejects
    (p_final < out_len).  The oracle and the native C read zeros past the
    end and accept any out_len; the native C rejects an escape byte or a
    u32 past the end, the oracle reads zeros there too.  [MS-XCA] §2.2.4
    takes every bit and escape byte from the input buffer and defines
    none past its end: the device paths are right, and the host codecs'
    zero fill, in both packages' copies, is the fault (ROADMAP.md queue
    3)."""
    s = _one_block({ord("a"): 1, ord("b"): 1}, bytes(4))
    got = pinned([(s, n) for n in range(1, 40)])
    ok = [n for n, (port, tp) in enumerate(got, 1) if port[0] == F.OK]
    assert [port for port, _ in got] == [tp for _, tp in got]
    assert ok == list(range(1, 18))
    assert got[16][0] == (F.OK, b"a" * 17)
    assert p_native.xh_decompress(s, 100) == p_oracle.decompress(s, 100) \
        == b"a" * 100
    assert M.xh_walk(s, 18)["past_end"] and not M.xh_walk(s, 16)["past_end"]
    assert M.classify(FMT, s, 18, {
        "device": got[17][0], "native": (F.OK, b"a" * 18),
        "oracle": (F.OK, b"a" * 18)}) == ["xh-reads-past-end"]
    # an escape byte past the end: the native C rejects, the oracle reads 0
    t = _one_block({ord("a"): 1, 256 + 15: 1},
                   (0b01 << 14).to_bytes(2, "little") + bytes(2))
    assert F.outcome(p_native.xh_decompress, t, 19) == ("DataError",)
    assert p_oracle.decompress(t, 19) == b"a" * 19
    assert pinned([(t, 19)])[0] == (("DataError",),) * 2


def test_u32_escape_wrap_pinned():
    """``xh-u32-escape-wrap``: a length-header-15 match whose u32 escape
    is 2^31 - 3 or more, after one literal "a" (both 1-bit codes; the
    match's offset is 1).  The device parses compute the length in int32
    (tpucomp ``xh_pallas.py:158-169``, ``codecs/xpress_huff.py:250-261``;
    the port's ``xh_parse``): at 2^32 - 3 it wraps to 0, the position
    stays and the rest decodes, so they accept; at 2^31 - 3 it turns
    negative and they reject.  The native C's ``(int)L + 3`` copies
    nothing at either and accepts.  The oracle's Python integer overruns
    out_len and rejects both.  [MS-XCA] §2.2.4 reads an unsigned 32-bit
    length, and a match past the output is invalid: the oracle is right;
    the fix of the device parses and the native C belongs to both
    packages at once (ROADMAP.md queue 3)."""
    lens = {ord("a"): 1, 256 + 15: 1}
    word = (0b01 << 14).to_bytes(2, "little")
    rows = []
    for value in (2 ** 32 - 3, 2 ** 31 - 3):
        esc = b"\xff\x00\x00" + value.to_bytes(4, "little")
        rows.append((_one_block(lens, word + bytes(2) + esc + bytes(16)), 64))
    got = pinned(rows)
    assert [port for port, _ in got] == [tp for _, tp in got]
    assert got[0][0] == (F.OK, b"a" * 64) and got[1][0] == ("DataError",)
    for (s, n), (dev, _) in zip(rows, got):
        walk = M.xh_walk(s, n)
        assert walk["wrap"] and walk["escapes"][0][1] == 7
        native = F.outcome(p_native.xh_decompress, s, n)
        assert native == F.outcome(t_native.xh_decompress, s, n)
        assert native == (F.OK, b"a" * n)
        oracle = F.outcome(p_oracle.decompress, s, n)
        assert oracle == ("DataError",)
        assert M.classify(FMT, s, n, {"device": dev, "native": native,
                                      "oracle": oracle}) == \
            ["xh-u32-escape-wrap"]


# ---- under -m slow: at least 10^4 mutants -----------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("op", OPS)
def test_slow_each_operator(op):
    recs = of_op(run(**SLOW)[0], op)
    assert len(recs) == SLOW["per_op"]
    msgs = all_faults(recs)
    assert not msgs, "\n".join(msgs[:20])


@pytest.mark.slow
def test_slow_ten_thousand_mutants():
    recs, multi = run(**SLOW)
    assert len(recs) >= 10_000 and len(multi) == SLOW["multi"]
    msgs = all_faults(recs) + all_faults(multi)
    assert not msgs, "\n".join(msgs[:20])
    print(F.summary("xpress_huff slow", recs))
    print(F.summary("xpress_huff slow, two-block one-shot", multi))

"""Differential mutation check of the LZNT1 decoders on the CPU.

Seeded mutants of valid LZNT1 streams (``tests/_mutate.py``) go through
(see ``tests/_fuzz.py``):

A. the device path of both packages: each mutant split into its chunks
   (``split_stream`` of each package), every chunk a row of one batch of
   [256k, 4616] (tpucomp's jitted ``decode_batch`` on its XLA path, the
   port's ``codecs.lznt1.decode_batch`` on the plain versions), err on
   every row, out_len and bytes where err is 0; a mutant's outcome is its
   rows' joined bytes, or DataError if a row has err.  On a sample, the
   one-shot ``decompress`` of both packages;
B. ``backend="cpu"`` (the native C decoder) and ``backend="oracle"``, the
   port's copies against tpucomp's;
C. in each package, the device path against the native C decoder and
   the oracle: every disagreement is ``lznt1-tokens-past-4096``.

Tier-1 runs 18 mutants an operator (9 operators); ``-m slow`` runs 1112
(10,008).  Every value is a byte or an integer: equality is exact.
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
from tpucomp.codecs import lznt1 as t_lz
from tpucomp.oracle import lznt1 as t_oracle
from tpucomp_torch import _native as p_native
from tpucomp_torch.codecs import lznt1 as lz
from tpucomp_torch.errors import DataError
from tpucomp_torch.oracle import lznt1 as p_oracle
from _threads import _one_thread  # noqa: F401

FMT = "lznt1"
OPS = M.OPERATORS[FMT]
TIER1 = dict(per_op=18, seed=20261018, sample=1)
SLOW = dict(per_op=1112, seed=20261019, sample=6)
CALL_ROWS = 2048  # rows of a batch call of the slow run
ROW_MULTIPLE = 256


@functools.lru_cache(maxsize=None)
def sources():
    """(stream, out_len) valid streams: corpus units, random bytes (stored
    chunks) and a run, by the native C and the oracle encoders."""
    rng = random.Random(0x1A7)
    units = [make_corpus(rng, n) for n in (200, 1500, 4096, 4097, 7000,
                                           9000, 12000, 16384)]
    units += [bytes(rng.randrange(256) for _ in range(5000)), b"ab" * 3000]
    return ([(p_native.lznt1_compress(u), len(u)) for u in units]
            + [(p_oracle.compress(u), len(u)) for u in units[1:6]])


def _split(split_stream, stream):
    try:
        return split_stream(stream)
    except Exception as e:  # noqa: BLE001 - the class is the outcome
        return (type(e).__name__,)


def _decode_rows(rows, calls):
    """Both packages' decode of ``rows`` (payload, is_comp), in calls of
    ``calls`` rows.  Returns each package's (out, out_len, err)."""
    n = len(rows)
    N = F.pad_rows(n, calls)
    payload = F.np_rows([p for p, _ in rows] + [b""] * (N - n),
                        lz.PAYLOAD_PAD)
    plen = np.array([len(p) for p, _ in rows] + [0] * (N - n), np.int32)
    comp = np.array([c for _, c in rows] + [False] * (N - n), bool)
    port, tp = [], []
    for a, b in F.chunked(N, calls):
        args = (payload[a:b], plen[a:b], comp[a:b])
        port.append([t.numpy() for t in lz.decode_batch(
            *lz.batch_from_numpy(*args, device="cpu"))])
        tp.append([np.asarray(t) for t in t_lz.decode_batch(
            *(jnp.asarray(x) for x in args))])
    return ([np.concatenate(p)[:n] for p in zip(*port)],
            [np.concatenate(p)[:n] for p in zip(*tp)])


@functools.lru_cache(maxsize=None)
def run(per_op: int, seed: int, sample: int):
    mutants = M.mutants(FMT, sources(), per_op * len(OPS), seed)
    records = [F.record(FMT, m) for m in mutants]
    rows, owner = [], []
    for i, r in enumerate(records):
        r["out_len"] = None  # LZNT1 is self-terminating
        got = _split(lz.split_stream, r["stream"])
        want = _split(t_lz.split_stream, r["stream"])
        r["row_faults"] += got != want
        r["split"] = got
        if isinstance(got[0], list):
            rows += list(zip(*got))
            owner += [i] * len(got[0])
    calls = CALL_ROWS if len(rows) > CALL_ROWS else ROW_MULTIPLE
    (out, olen, err), (t_out, t_olen, t_err) = _decode_rows(rows, calls)
    bad = (err != t_err) | (~err & ((olen != t_olen)
                                    | (out != t_out).any(axis=1)))
    parts = {}
    for k, i in enumerate(owner):
        records[i]["row_faults"] += int(bad[k])
        parts.setdefault(i, []).append(k)
    for i, r in enumerate(records):
        o = r["outcomes"]
        if not isinstance(r["split"][0], list):
            o["port_device"] = o["tp_device"] = r["split"]
        else:
            ks = parts.get(i, [])
            for side, (oo, ll, ee) in (("port_device", (out, olen, err)),
                                       ("tp_device", (t_out, t_olen, t_err))):
                o[side] = (("DataError",) if any(ee[k] for k in ks) else
                           (F.OK, b"".join(oo[k, :ll[k]].astype(np.uint8)
                                           .tobytes() for k in ks)))
        F.host_outcomes(r, p_native.lznt1_decompress,
                        t_native.lznt1_decompress, p_oracle.decompress,
                        t_oracle.decompress)
        F.classify(r)
    # the one-shot calls on the first ``sample`` mutants of each operator
    for op in OPS:
        for r in [r for r in records if r["op"] == op][:sample]:
            r["oneshot"] = (
                F.outcome(lambda s: lz.decompress(s, device="cpu"),
                          r["stream"]),
                F.outcome(t_lz.decompress, r["stream"]))
    return records


def of_op(records, op):
    return [r for r in records if r["op"] == op]


def oneshot_faults(records) -> list:
    """The one-shot calls against each other and against the batch."""
    return [f"one-shot {r['oneshot'][0][0]} / tpucomp "
            f"{r['oneshot'][1][0]}, batch {r['outcomes']['port_device'][0]}"
            f": " + F.hint(r) for r in records if "oneshot" in r and not (
                r["oneshot"][0] == r["oneshot"][1]
                == r["outcomes"]["port_device"])]


# ---- tier-1: each operator --------------------------------------------------

@pytest.mark.parametrize("op", OPS)
def test_device_path_equals_tpucomp(op):
    recs = of_op(run(**TIER1), op)
    assert len(recs) == TIER1["per_op"]
    msgs = (F.row_faults(recs) + F.faults(recs, F.A_PAIRS)
            + oneshot_faults(recs))
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
    rejects others, and the stream splits fail on some."""
    recs = run(**TIER1)
    print(F.summary("lznt1 tier-1", recs))
    for side in ("port_device", "port_native", "port_oracle"):
        oks = [r["outcomes"][side][0] == F.OK for r in recs]
        assert 0.2 < np.mean(oks) < 0.9, side
    assert any(not isinstance(r["split"][0], list) for r in recs)


# ---- the pinned case of the class -------------------------------------------

def test_tokens_past_4096_pinned():
    """``lznt1-tokens-past-4096``: a compressed chunk whose tokens fill
    4096 bytes and go on.  Both device paths stop at 4096 and accept (the
    parse's ``active`` needs p < 4096: tpucomp ``codecs/lznt1.py:130``,
    ``lznt1_pallas.py``); the native C and the oracle reject ("chunk
    decompressed past 4096 bytes").  [MS-XCA] §2.5 (LZNT1): a chunk
    decompresses to at most 4096 bytes, so such a chunk is malformed: the
    host codecs are right, and the device paths keep tpucomp's behaviour
    (ROADMAP.md queue 3)."""
    # "a", then one copy of 4095 bytes at displacement 1 (p = 1: 12 length
    # bits), then a literal past the 4096th byte
    tok = 4095 - 3
    payload = bytes([0b010, ord("a")]) + tok.to_bytes(2, "little") + b"b"
    stream = (0xB000 | (len(payload) - 1)).to_bytes(2, "little") + payload
    want = b"a" * 4096
    assert lz.decompress(stream, device="cpu") == want
    assert t_lz.decompress(stream) == want
    for decode in (p_native.lznt1_decompress, t_native.lznt1_decompress,
                   p_oracle.decompress, t_oracle.decompress):
        with pytest.raises(Exception) as e:
            decode(stream, None)
        assert type(e.value).__name__ == "DataError"
    assert M.lznt1_walk(stream)["past_4096"]
    assert M.classify(FMT, stream, None, {
        "device": (F.OK, want), "native": ("DataError",),
        "oracle": ("DataError",)}) == ["lznt1-tokens-past-4096"]


# a mutant of the class that the tier-1 seed makes past its first 162:
# (seed, index, operator), rebuilt from the sources above
PAST_4096_MUTANT = (TIER1["seed"], 766, "set_byte")


def test_tokens_past_4096_from_the_fuzz():
    """A mutant in the class, rebuilt from (format, seed, index,
    operator): one byte set in a chunk makes it reach 4096 bytes before
    its last tokens.  Both device paths accept it with the same bytes;
    the host codecs reject it."""
    seed, index, op = PAST_4096_MUTANT
    m = M.mutant(FMT, sources(), seed, index, op)
    got = lz.decompress(m.stream, device="cpu")
    assert got == t_lz.decompress(m.stream)
    outs = {"device": (F.OK, got)}
    for side, decode in (("native", p_native.lznt1_decompress),
                         ("oracle", p_oracle.decompress)):
        outs[side] = F.outcome(decode, m.stream, None)
        assert outs[side] == ("DataError",)
    with pytest.raises(DataError):
        p_native.lznt1_decompress(m.stream)
    assert M.classify(FMT, m.stream, None, outs) == ["lznt1-tokens-past-4096"]


# ---- under -m slow: at least 10^4 mutants -----------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("op", OPS)
def test_slow_each_operator(op):
    recs = of_op(run(**SLOW), op)
    assert len(recs) == SLOW["per_op"]
    F.check(recs)
    msgs = oneshot_faults(recs)
    assert not msgs, "\n".join(msgs)


@pytest.mark.slow
def test_slow_ten_thousand_mutants():
    recs = run(**SLOW)
    assert len(recs) >= 10_000
    F.check(recs)
    print(F.summary("lznt1 slow", recs))

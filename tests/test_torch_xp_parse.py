"""tpucomp_torch's plain Xpress parse, in its plain PyTorch version on the
CPU, against tpucomp's: its Pallas kernel in interpret mode (as tpucomp's
own tests run it) and its XLA scan.  The records compare filled (the slot
layouts differ: tpucomp's kernel packs a plane, its scan carries the last
record into every step), p_final and err exactly, on every row.

Rows: units encoded by tpucomp, the oracle and the native C encoder;
hand-built streams with every escape (nibble, byte, u16, u32) and shared
nibbles across tokens past a 32-token group; and malformed rows (cut
short, trailing bytes, a match before the start, a match past out_len,
escape lengths below 22, and a u32 length that wraps int32).  The same
seeded inputs go through both packages as numpy arrays; every value is an
integer, so the tolerance is exact equality.
"""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_corpus
from tpucomp import _native
from tpucomp.codecs import xpress as t_xp
from tpucomp.kernels import common as t_common
from tpucomp.kernels import xp_pallas
from tpucomp.oracle import xpress as oracle
from tpucomp_torch.codecs import xpress as xp
from tpucomp_torch.kernels import fill, xp_parse

U = 4096


def _write(tokens) -> bytes:
    """A stream of hand-chosen tokens: ("lit", byte), ("match", offset,
    length) with the format's escapes, or ("u32", offset, value), a match
    whose length takes the u32 escape whatever its value (value + 3)."""
    w = oracle._Writer()
    for tok in tokens:
        if tok[0] == "lit":
            w.put_flag(0)
            w.put_byte(tok[1])
        elif tok[0] == "match":
            oracle._emit_match(w, tok[1], tok[2])
        else:
            w.put_flag(1)
            w.put_u16(((tok[1] - 1) << 3) | 7)
            w.put_nibble(15)
            w.put_byte(255)
            w.put_u16(0)
            w.out += (tok[2] & 0xFFFFFFFF).to_bytes(4, "little")
    return w.finish()


def _escapes():
    """Every escape, nibble users in pairs and alone, past 32 tokens:
    (stream, decoded length)."""
    toks = [("lit", 65 + k) for k in range(5)]
    n = 5
    for length in (3, 9, 10, 24, 25, 30, 279, 280, 1000, 9, 4, 103, 26, 17,
                   11, 600, 5, 12, 13, 14, 15, 16, 300, 7, 8, 3, 40):
        if length == 103:
            toks.append(("u32", 2, 100))  # a u32 escape of a small length
        else:
            toks.append(("match", 1 + length % 5, length))
        n += length
        toks.append(("lit", 90 + length % 7))
        n += 1
    assert len(toks) > 40 and n <= U
    return _write(toks), n


def _rows():
    """(stream, out_len) of every kind; the first ``n_good`` decode."""
    rng = random.Random(0xC0FFEE)
    r = np.random.default_rng(5)
    text = make_corpus(rng, U)
    other = make_corpus(rng, U - 700)
    noise = r.integers(0, 256, 1500, dtype=np.uint8).tobytes()
    tpu = t_xp.compress_units([text], unit_size=U)[0]
    esc, esc_n = _escapes()
    good = [(tpu, U), (oracle.compress(other), len(other)),
            (_native.xpress_compress(text), U), (esc, esc_n),
            (oracle.compress(noise), len(noise)),
            (oracle.compress(b"q" * U), U), (b"", 0)]
    bad = [
        (tpu[:len(tpu) // 2], U),  # cut short
        (tpu + bytes(range(40)), U),  # trailing bytes past out_len: fine
        (_write([("match", 5, 10)]), 10),  # offset 5 > position 0
        (_write([("lit", 1), ("match", 1, 300)]), 100),  # past out_len
        (_write([("lit", 1), ("match", 1, 2000)])[:9] + b"\x05\x00", 2001),
        (_write([("lit", 1), ("u32", 1, -5 & 0xFFFFFFFF)]), 50),  # negative
        # a u32 length of 2^31 - 3 wraps the match length to -2^31: the
        # position goes negative with err clear (tpucomp's arithmetic)
        (_write([("lit", 7), ("u32", 1, (1 << 31) - 3), ("lit", 8),
                 ("lit", 9)]), 4),
        (b"", 20),  # nothing to parse
    ]
    return good, bad


@functools.lru_cache(maxsize=None)
def _batch():
    """The numpy batch (payload int32 [N, P], plen, out_len) and how many
    rows are well-formed (the trailing-bytes row is, too)."""
    good, bad = _rows()
    rows = good + bad
    P = -(-max(len(s) for s, _ in rows) // 128) * 128
    payload = np.zeros((len(rows), P), np.int32)
    plen = np.zeros(len(rows), np.int32)
    olen = np.zeros(len(rows), np.int32)
    for k, (s, o) in enumerate(rows):
        payload[k, :len(s)] = np.frombuffer(s, np.uint8)
        plen[k], olen[k] = len(s), o
    return payload, plen, olen, len(good)


WRAP_ROW = -2  # the u32 wrap row, counted from the end


@functools.lru_cache(maxsize=None)
def _port():
    payload, plen, olen, _ = _batch()
    return xp_parse.xp_parse(*xp.batch_from_numpy(payload, plen, olen,
                                                  device="cpu"), U)


def _filled(rec_pos, rec_val):
    """tpucomp's XLA fill of records (numpy), as its decode tail runs it."""
    return [np.asarray(a) for a in t_common.fill_records_delta2(
        jnp.asarray(rec_pos), jnp.asarray(rec_val), U)[:2]]


def _port_filled():
    rec_pos, rec_val, _, _ = _port()
    return [a.numpy() for a in fill.fill_records_delta2_ref(
        rec_pos, rec_val, U)[:2]]


def test_parse_matches_pallas_interpret():
    """Every row against tpucomp's Pallas parse in interpret mode; the
    filled records on every row but the wrap row, whose negative positions
    the kernel's packed plane cannot hold (its XLA scan can: see below)."""
    payload, plen, olen, _ = _batch()
    rec_pos, rec_val, p_final, err = _port()
    t_pos, t_val, t_p, t_err = (np.array(a) for a in xp_pallas.parse_records(
        jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(olen), U,
        interpret=True))
    np.testing.assert_array_equal(p_final.numpy(), t_p)
    np.testing.assert_array_equal(err.numpy(), t_err)
    keep = np.arange(len(plen)) != len(plen) + WRAP_ROW
    for g, w in zip(_port_filled(), _filled(t_pos, t_val)):
        np.testing.assert_array_equal(g[keep], w[keep])
    # records sit at their byte step, empty slots keyed SENT
    real = rec_pos.numpy() != xp_parse.SENT
    np.testing.assert_array_equal(real[keep], (t_pos != xp_pallas.SENT)[keep])


def _xla_scan(monkeypatch):
    """tpucomp's XLA scan's (rec_pos, rec_val, p_final, err): its decode
    with the tail replaced by one that returns the tail's inputs."""
    payload, plen, olen, _ = _batch()
    monkeypatch.setattr(t_xp, "_records_to_output", lambda *a, **k: a[:4])
    return [np.array(a) for a in t_xp._decode_impl(
        jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(olen), U)]


def test_parse_matches_xla_scan(monkeypatch):
    """Every row, the wrap row included, against tpucomp's XLA scan."""
    _, _, p_final, err = _port()
    t_pos, t_val, t_p, t_err = _xla_scan(monkeypatch)
    np.testing.assert_array_equal(p_final.numpy(), t_p)
    np.testing.assert_array_equal(err.numpy(), t_err)
    for g, w in zip(_port_filled(), _filled(t_pos, t_val)):
        np.testing.assert_array_equal(g, w)


def test_rows_decode_or_fail_as_expected():
    """The well-formed rows parse clean to their length; each malformed
    row fails the way it was built to, through err or a short p_final."""
    _, _, olen, n_good = _batch()
    _, _, p_final, err = _port()
    p, e = p_final.numpy(), err.numpy()
    ok = (e == 0) & (p >= olen)
    assert ok[:n_good].all()
    bad = ok[n_good:].tolist()
    assert bad == [False, True, False, False, False, False, False, False]
    assert e[n_good + 2: n_good + 6].tolist() == [1, 1, 1, 1]
    # the wrap: err clear in the parse, the position far below zero
    assert e[WRAP_ROW] == 0 and p[WRAP_ROW] == 1 - (1 << 31) + 2
    assert p[n_good] < olen[n_good] and e[n_good] == 0  # cut short


def test_escape_row_covers_every_escape():
    """The hand-built row decodes through the oracle, and its stream holds
    nibble, byte, u16 and u32 escapes with a shared nibble byte."""
    esc, n = _escapes()
    data = oracle.decompress(esc, n)
    assert len(data) == n
    _, _, p_final, err = _port()
    assert p_final[3] == n and err[3] == 0


@pytest.mark.parametrize("n_rows", [0, 3])
def test_parse_of_empty_and_tiny_batches(n_rows):
    """Edge shapes: no rows at all, and rows of a few bytes."""
    payload = torch.zeros((n_rows, 16), dtype=torch.uint8)
    plen = torch.full((n_rows,), 4, dtype=torch.int32)
    olen = torch.full((n_rows,), 3, dtype=torch.int32)
    rec_pos, rec_val, p_final, err = xp_parse.xp_parse(payload, plen, olen,
                                                       512)
    assert rec_pos.shape == (n_rows, 16) and (rec_pos == xp_parse.SENT).all()
    # a zero flag word then nothing: no token, p stays 0
    assert (p_final == 0).all() and (err == 0).all()

"""The segment-parallel XH parse of ``csrc/xh_parse.cu``, as a numpy
model, against the plain parse ``xh_parse.xh_parse_ref``.

The model cuts a row's body into segments (:func:`xh_parse.segments`)
and decodes each with the parse's byte machine, as the kernel does:

- speculative rounds: segment t > 0 first decodes from a guess, the state
  the machine reaches from its initial state over the ``WARM`` bytes
  before the segment; each round then re-decodes every segment whose
  entry (its left neighbour's exit in the round before) differs, in its
  live fields, from the entry it last used, until no entry changes;
- tier-3 rows (``ss == 3``): ``HYP`` hypotheses of each coarse segment's
  entry, decoded side by side, then resolved left to right, a segment
  whose true entry is no hypothesis re-decoded;
- the final pass: every segment from its true entry, at its absolute
  position and record slot, with every guard.

In the rounds positions are relative and the ``p < out_len`` guards are
off, which is exact up to the row's stop (see the kernel's notes).  The
model gives each row's round count as the kernel defines it, so the card
tests hold the kernel's ``rounds`` to it.  Every value is an integer: the
tolerance is exact equality.

The file also writes XH streams token by token (:func:`write_stream`),
driven by the same machine, so that rows can place a segment boundary
inside an escape, on a pending offset, at odd word parity or in the
32-bit prime.  It imports neither JAX nor tpucomp at module level: the
card tests import it.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

from tpucomp_torch.codecs import xpress_huff as xh
from tpucomp_torch.kernels import huffman, xh_parse
from _threads import _one_thread  # noqa: F401

M32 = 0xFFFFFFFF
COPY_BIT = xh_parse.COPY_BIT
SENT = xh_parse.SENT
(W0, W1, EB, E16A, E16B, E32A, E32B, E32C, E32D) = range(9)
NONE, OFFSET, ESC = range(3)
INIT = (W0, NONE, 0, 0, 0, 0, 0, 0, 0)
# a state: (mode, pend, bitbuf, bitcount, lowbyte, obc, lh, off, len_acc)


def i32(x):
    """x wrapped to int32."""
    return ((x + (1 << 31)) & M32) - (1 << 31)


def canon(st):
    """The state with its dead fields zeroed: two states that agree here
    decode the same from any byte on."""
    mode, pend, bitbuf, bitcount, lowbyte, obc, lh, off, len_acc = st
    return (mode, pend, bitbuf, bitcount,
            lowbyte if mode == W1 else 0,
            obc if pend == OFFSET else 0, lh if pend == OFFSET else 0,
            off if pend == ESC else 0,
            len_acc if mode in (E16B, E32B, E32C, E32D) else 0)


class Row:
    """One row's tables, each 15-bit window's level (0: no code) and
    symbol precomputed, as the kernel's compares and lookups give them."""

    def __init__(self, body, blen, olen, ss, lim15, rbf, sym, U):
        self.body = [int(b) for b in body[:max(0, min(int(blen), len(body)))]]
        self.blen = len(self.body)
        self.olen, self.ss, self.U = int(olen), int(ss), U
        lim15 = np.asarray(lim15, np.int64)
        rbf = np.asarray(rbf, np.int64)
        peek = np.arange(1 << 15)
        level = 1 + (peek[:, None] >= lim15[None, 1:15]).sum(1)
        rank = ((rbf[level] + (peek >> (15 - level)) + (1 << 31)) & M32) \
            - (1 << 31)
        ok = (rank >= 0) & (rank < 512)
        sy = np.where(ok, np.asarray(sym)[np.where(ok, rank, 0)], 0)
        self.level = np.where(peek < lim15[15], level, 0).tolist()
        self.sym = sy.tolist()


def decode(row, s0, s1, st, p, k, final=False, out=None, feed=None):
    """Run the byte machine over body bytes [s0, s1) from state ``st`` at
    position p with k records made.  ``final``: absolute positions, every
    guard and err; records (slot, pos, val) go to ``out``.  Otherwise
    relative positions, no guards, no err.  ``feed(mode)``, if given,
    supplies each byte (and the body is not read).

    Returns (state, p, k, err)."""
    mode, pend, bitbuf, bitcount, lowbyte, obc, lh, off, len_acc = st
    olen, U, ss = row.olen, row.U, row.ss
    LV, SY, body = row.level, row.sym, row.body
    err = 0
    for s in range(s0, s1):
        if final and p >= olen:
            break
        b = body[s] if feed is None else feed(mode)
        esc_len = None
        w1 = False
        if mode == W0:
            lowbyte, mode = b, W1
        elif mode == W1:
            sh = 16 - bitcount
            if sh >= 0:
                bitbuf = (bitbuf | ((lowbyte | b << 8) << sh)) & M32
            bitcount += 16
            w1, mode = True, W0
        elif mode == EB:
            if b < 255:
                esc_len, mode = b + 18, W0
            else:
                mode = E16A
        elif mode == E16A:
            len_acc, mode = b, E16B
        elif mode == E16B:
            u16v = len_acc | b << 8
            if u16v == 0:
                mode = E32A
            else:
                esc_len, mode = u16v + 3, W0
        elif mode == E32A:
            len_acc, mode = b, E32B
        elif mode == E32B:
            len_acc, mode = len_acc | b << 8, E32C
        elif mode == E32C:
            len_acc, mode = len_acc | b << 16, E32D
        else:
            esc_len, mode = i32((len_acc | b << 24) + 3), W0
        if esc_len is not None:
            end = i32(p + esc_len)
            if final:
                if off > p or end > olen:
                    err = 1
                if k < U:
                    out.append((k, p, COPY_BIT | off))
                p = min(end, U)
            else:
                p = end
            k += 1
            pend = NONE
        elif not (w1 and s >= 3):  # the 32-bit prime
            continue
        for _ in range(ss):
            acted = False
            if pend == OFFSET and bitcount >= obc:
                raw = (bitbuf >> (32 - obc)) & ((1 << obc) - 1) if obc else 0
                offv = 1 << obc | raw
                bitbuf = (bitbuf << obc) & M32
                bitcount -= obc
                if lh < 15:
                    mlen = lh + 3
                    if final:
                        if offv > p or p + mlen > olen:
                            err = 1
                        if k < U:
                            out.append((k, p, COPY_BIT | offv))
                        p = min(p + mlen, U)
                    else:
                        p = i32(p + mlen)
                    k += 1
                    pend = NONE
                else:
                    pend = ESC
                off = offv
                acted = True
            if pend == NONE and bitcount >= 16 and (not final or p < olen):
                peek = bitbuf >> 17
                level = LV[peek]
                if level:
                    sy = SY[peek]
                    bitbuf = (bitbuf << level) & M32
                    bitcount -= level
                    if sy < 256:
                        if final and k < U:
                            out.append((k, p, sy))
                        p = i32(p + 1)
                        k += 1
                    else:
                        obc, lh, pend = (sy - 256) >> 4, (sy - 256) & 15, OFFSET
                    acted = True
            if not acted or (final and p >= olen):
                break
        if final and p < olen and (
                (pend == NONE and bitcount >= 16)
                or (pend == OFFSET and bitcount >= obc)):
            err = 1
        mode = EB if pend == ESC and bitcount >= 16 else W0
    return (mode, pend, bitbuf, bitcount, lowbyte, obc, lh, off,
            len_acc), p, k, err


def guess(row, b):
    """Round 1's entry of a segment starting at b: the machine run from
    its initial state over the WARM bytes before b (exact from byte 0)."""
    st, _, _, _ = decode(row, max(0, b - xh_parse.WARM), b, INIT, 0, 0)
    return canon(st)


def hypothesis(row, b, c):
    """Tier-3 hypothesis c of a segment starting at b: a word boundary
    with c bits left over, the low c bits of the word in bytes b-2, b-1."""
    word = row.body[b - 2] | row.body[b - 1] << 8
    return (W0, NONE, (word & ((1 << c) - 1)) << (32 - c) & M32 if c else 0,
            c, 0, 0, 0, 0, 0)


def segment_row(row, seg=None):
    """The kernel's parse of one row: (records [(slot, pos, val)],
    p_final, err, rounds).  ``seg`` overrides the segment length."""
    S, nseg = xh_parse.segments(row.blen, row.ss)
    if seg is not None:
        S, nseg = seg, -(-row.blen // seg) if row.blen > 0 else 0
    if nseg == 0:
        return [], 0, 0, 0
    bounds = [(t * S, min((t + 1) * S, row.blen)) for t in range(nseg)]

    def spec(t, st):
        ex, dp, dk, _ = decode(row, *bounds[t], st, 0, 0)
        return canon(ex), dp, dk

    if row.ss == 3:
        # every coarse segment under every hypothesis, then left to right
        lo = xh_parse.HYP_LO
        hyp = [None] + [[spec(t, hypothesis(row, bounds[t][0], c))
                         for c in range(lo, lo + xh_parse.HYP)]
                        for t in range(1, nseg)]
        entries = [INIT]
        res = [spec(0, INIT)]
        rounds = 0
        for t in range(1, nseg):
            e = res[-1][0]
            entries.append(e)
            c = e[3] - xh_parse.HYP_LO
            if e[0] == W0 and e[1] == NONE and 0 <= c < xh_parse.HYP and \
                    e == hypothesis(row, bounds[t][0], e[3]):
                res.append(hyp[t][c])
            else:
                res.append(spec(t, e))
                rounds += 1
    else:
        entries = [INIT] + [guess(row, b) for b, _ in bounds[1:]]
        res = [spec(t, entries[t]) for t in range(nseg)]
        rounds = 1
        while True:
            new = [INIT] + [x for x, _, _ in res[:-1]]
            changed = [t for t in range(nseg) if new[t] != entries[t]]
            if not changed:
                break
            rounds += 1
            for t in changed:
                entries[t] = new[t]
                res[t] = spec(t, new[t])

    # the final pass: every segment at its absolute position and slot;
    # the first that reaches out_len ends the row
    out, err, p, k = [], 0, 0, 0
    for t in range(nseg):
        st, p_end, k_end, e = decode(row, *bounds[t], entries[t], p, k,
                                     final=True, out=out)
        err |= e
        if p_end >= row.olen:
            p, k = p_end, k_end
            break
        assert (p_end, k_end) == (i32(p + res[t][1]), k + res[t][2])
        p, k = p_end, k_end
    return out, p, err | int(k > row.U), rounds


def segment_parse(body, blen, out_len, ss, lim15, rbf, sym_by_rank, U,
                  seg=None):
    """:func:`segment_row` over a batch of numpy (or CPU tensor) inputs:
    (rec_pos, rec_val int32 [N, U], p_final, err, rounds int32 [N])."""
    body, blen, out_len, ss, lim15, rbf, sym_by_rank = (
        np.asarray(a) for a in (body, blen, out_len, ss, lim15, rbf,
                                sym_by_rank))
    N = body.shape[0]
    rec_pos = np.full((N, U), SENT, np.int32)
    rec_val = np.zeros((N, U), np.int32)
    p_final, err, rounds = (np.zeros(N, np.int32) for _ in range(3))
    for n in range(N):
        row = Row(body[n], blen[n], out_len[n], ss[n], lim15[n], rbf[n],
                  sym_by_rank[n], U)
        recs, p_final[n], err[n], rounds[n] = segment_row(row, seg)
        for slot, pos, val in recs:
            rec_pos[n, slot], rec_val[n, slot] = pos, val
    return rec_pos, rec_val, p_final, err, rounds


def boundary_states(row):
    """The machine's state before every body byte, from the row's start
    (relative positions, no guards)."""
    states, st = [], INIT
    for s in range(row.blen):
        states.append(st)
        st, _, _, _ = decode(row, s, s + 1, st, 0, 0)
    return states


KINDS = {
    "u16 escape": lambda st: st[0] in (E16A, E16B),
    "u32 escape": lambda st: st[0] in (E32A, E32B, E32C, E32D),
    "pending offset": lambda st: st[1] == OFFSET,
    "odd word parity": lambda st: st[0] == W1,
}


# ---- streams written token by token ----------------------------------------

def table_bytes(lengths):
    """The 256-byte table of 512 code lengths."""
    ln = np.asarray(lengths, np.int64)
    return bytes((ln[0::2] | ln[1::2] << 4).astype(np.uint8))


def write_stream(lengths, tokens):
    """An XH unit stream of ``tokens`` under the code ``lengths`` (512):
    ``("lit", byte)`` or ``("match", offset, length)``.  A length past
    65538, or one outside [3, 65538], goes as a u32 escape of
    ``(length - 3) mod 2**32`` (so the machine adds ``length`` wrapped to
    int32).  The bytes come from the machine itself: a refill word from
    the code bits, an escape byte when it asks for one.

    Returns (stream, out_len): out_len is the position after the tokens."""
    codes = huffman.canonical_from_lengths(
        torch.tensor(np.asarray(lengths, np.int32))[None])[0][0].tolist()
    bits, escapes, olen = [], [], 0

    def put(value, width):
        bits.extend((value >> (width - 1 - i)) & 1 for i in range(width))

    for tok in tokens:
        if tok[0] == "lit":
            assert lengths[tok[1]] > 0
            put(codes[tok[1]], lengths[tok[1]])
            olen += 1
            continue
        _, offset, length = tok
        obc = offset.bit_length() - 1
        lh = 15 if not 3 <= length < 18 else length - 3
        sym = 256 + (obc << 4 | lh)
        assert lengths[sym] > 0
        put(codes[sym], lengths[sym])
        put(offset - (1 << obc), obc)
        if lh == 15:
            if 18 <= length < 273:
                escapes.append(length - 18)
            elif 273 <= length < 65539:
                escapes += [255, (length - 3) & 255, (length - 3) >> 8]
            else:
                u32 = (length - 3) & M32
                escapes += [255, 0, 0] + [(u32 >> (8 * i)) & 255
                                          for i in range(4)]
        olen = i32(olen + length)
    body, state = [], {"hi": 0, "bit": 0, "esc": 0}

    def feed(mode):
        if mode == W0:
            chunk = bits[state["bit"]:state["bit"] + 16]
            state["bit"] += 16
            word = int("".join(map(str, chunk + [0] * (16 - len(chunk)))), 2)
            state["hi"] = word >> 8
            b = word & 255
        elif mode == W1:
            b = state["hi"]
        else:
            b = escapes[state["esc"]]
            state["esc"] += 1
        body.append(b)
        return b

    table = table_bytes(lengths)
    row = Row(b"", 0, 0, xh._substeps_for(min(l for l in lengths if l)),
              *(a[0].numpy() for a in _tables(table)), 1 << 16)
    st = INIT
    # until the machine has taken every code bit (the bits fed less those
    # left in its window) and every escape byte
    while (state["bit"] - st[3] < len(bits) or state["esc"] < len(escapes)
           or st[0] != W0):
        st, _, _, _ = decode(row, len(body), len(body) + 1, st, 0, 0,
                             feed=feed)
    return table + bytes(body), olen


def _tables(table):
    lengths = huffman.unpack_table(
        torch.frombuffer(bytearray(table), dtype=torch.uint8)[None])
    _, fc, br, lim = huffman.canonical_from_lengths(lengths)
    lim15, rbf = huffman.level_tables(fc, br, lim)
    return lim15, rbf, huffman.rank_to_symbol_table(lengths)


def code_lengths(tier):
    """Code lengths (512, Kraft sum at most 1) whose shortest code gives
    substep tier 3 (8 bits) or 5 (6 bits)."""
    ln = np.zeros(512, np.int64)
    if tier == 3:
        ln[:128], ln[128:256], ln[256:] = 8, 9, 10  # 1/2 + 1/4 + 1/4
    else:
        ln[:16], ln[16:128], ln[128:256], ln[256:] = 6, 8, 10, 11
    return ln.tolist()


def storm_tokens(r, n_out, kinds=("u16", "esc8", "far"), lit_frac=0.7):
    """Seeded tokens for n_out output bytes rich in what a segment
    boundary can fall on: 1-byte (``esc8``, each flips the word parity)
    and u16 (``u16``) escapes, far offsets (``far``: up to 15 offset bits,
    often pending at a boundary), short matches and literals; ``u32``: a
    u32 escape of length 1 or 2."""
    toks, p = [], 0
    while p < n_out:
        room = n_out - p
        x = r.random()
        if p < 2 or x < lit_frac or room < 3:
            toks.append(("lit", int(r.integers(0, 128))))
            p += 1
            continue
        kind = kinds[int(r.integers(0, len(kinds)))]
        off = int(r.integers(1, p + 1))
        if kind == "far":
            off = int(r.integers(max(1, p // 2), p + 1)) if p > 1 else 1
            length = int(r.integers(3, 18))
        elif kind == "esc8":
            length = int(r.integers(18, 80))
        elif kind == "u16":
            length = int(r.integers(273, 400))
        else:
            length = int(r.integers(1, 3))
        off = min(off, (1 << 16) - 1)
        length = min(length, room) if kind != "u32" else length
        if kind != "u32" and length < 3:
            toks.append(("lit", 7))
            p += 1
            continue
        toks.append(("match", off, length))
        p += length
    return toks


def rows_batch(rows, U, device="cpu"):
    """(stream, out_len) rows -> the parse's inputs at width U."""
    batch = xh.pack_units([s for s, _ in rows], [o for _, o in rows], U,
                          device)
    return xh.parse_inputs(*batch)


# ---- the tests -------------------------------------------------------------

def _hold(args, U, segs=(None,)):
    """The model, at each segment length of ``segs`` (None: the
    kernel's), against xh_parse_ref on the same inputs; returns the
    model's rounds at each."""
    want = [w.numpy() for w in xh_parse.xh_parse_ref(*args, U)]
    out = []
    for seg in segs:
        *got, rounds = segment_parse(*(a.numpy() for a in args), U, seg=seg)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        out.append(rounds)
    return out


def _records(rec_pos, rec_val):
    """A row's records in slot order, empty slots dropped."""
    keep = np.asarray(rec_pos) != SENT
    return list(zip(np.asarray(rec_pos)[keep].tolist(),
                    np.asarray(rec_val)[keep].tolist()))


def _hold_to_pallas(rows, U):
    """tpucomp's Pallas parse (interpret mode, one call per substep tier
    as its buckets make them) of (stream, out_len) ``rows`` at width U,
    against the plain parse and the model on the same rows: p_final and
    err exactly on every row; on the rows without err, each row's records
    in slot order (tpucomp leaves empty slots between them) and the
    records filled.  A row with err may hold positions outside [0, U),
    which tpucomp's records pack into 16 bits (xh_pallas.py:23-29), and
    its records are not used."""
    import jax.numpy as jnp
    from test_torch_xh_parse import _lengths, _tpu_tables  # imports JAX
    from tpucomp.kernels import common as t_common
    from tpucomp.kernels import xh_pallas

    from tpucomp_torch.kernels import fill

    args = rows_batch(rows, U)
    ref = [a.numpy() for a in xh_parse.xh_parse_ref(*args, U)]
    mod = segment_parse(*(a.numpy() for a in args), U)[:4]
    P = -(-max(len(s) for s, _ in rows) // 64) * 64 + 256
    payload = np.zeros((len(rows), P), np.int32)
    for k, (stream, _) in enumerate(rows):
        payload[k, :len(stream)] = np.frombuffer(stream, np.uint8)
    plen = np.array([len(stream) for stream, _ in rows], np.int32)
    olen = np.array([o for _, o in rows], np.int32)
    _, fc, br, lim, sym = _tpu_tables(_lengths(payload))
    ss = args[3].numpy()
    for tier in sorted(set(ss.tolist())):
        at = np.nonzero(ss == tier)[0]
        pb = max(64, -(-int(plen[at].max() - 256) // 64) * 64)
        t_pos, t_val, t_p, t_err = (np.array(a) for a in
                                    xh_pallas.parse_records(
            jnp.asarray(payload[at, 256:256 + pb]),
            jnp.asarray(plen[at] - 256), jnp.asarray(olen[at]),
            jnp.asarray(fc[at]), jnp.asarray(br[at]), jnp.asarray(lim[at]),
            jnp.asarray(sym[at]), U, tier, interpret=True))
        ok = t_err == 0
        want = [np.asarray(a)[ok] for a in t_common.fill_records_delta2(
            jnp.asarray(t_pos), jnp.asarray(t_val), U)]
        for pos, val, p_got, err_got in (ref, mod):
            np.testing.assert_array_equal(p_got[at], t_p)
            np.testing.assert_array_equal(err_got[at], t_err)
            for i in np.nonzero(ok)[0]:
                assert _records(pos[at[i]], val[at[i]]) == _records(
                    t_pos[i], t_val[i])
            got = fill.fill_records_delta2_ref(
                torch.as_tensor(pos[at][ok]), torch.as_tensor(val[at][ok]),
                U)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w)
    return args


@functools.lru_cache(maxsize=None)
def _xh_rows():
    from test_torch_xh_parse import U, _stream_rows  # imports JAX
    good, bad = _stream_rows()
    return good + bad, U


def test_model_equals_plain_parse_on_the_xh_rows():
    """Valid rows at tiers 3, 5 and 17 and the malformed rows of the XH
    parse tests, at the kernel's geometry and at two others."""
    rows, U = _xh_rows()
    args = rows_batch(rows, U)
    assert {3, 5, 17} <= set(args[3].tolist())
    for rounds in _hold(args, U, (36, 1000, None)):
        assert (rounds >= 0).all()


@pytest.mark.parametrize("tier", [3, 5])
@pytest.mark.parametrize("kind", sorted(KINDS) + ["prime"])
def test_boundary_inside(kind, tier):
    """Segment boundaries placed on each kind of state: inside a u16 and a
    u32 escape, on a pending offset, at odd word parity, and inside the
    32-bit prime (bytes 1 to 3, on a short row)."""
    r = np.random.default_rng(["prime", *sorted(KINDS)].index(kind) + tier)
    kinds = ("u32", "esc8") if kind == "u32 escape" else ("u16", "esc8",
                                                          "far")
    n_out = {"prime": 40, "u32 escape": 15000}.get(kind, 60000)
    stream, olen = write_stream(code_lengths(tier),
                                storm_tokens(r, n_out, kinds))
    U = 1 << 16
    args = rows_batch([(stream, olen), (stream, U)], U)
    assert int(args[3][0]) == tier
    row = Row(*(a[0].numpy() for a in args), U)
    if kind == "prime":
        xs = [1, 2, 3]
    else:
        states = boundary_states(row)
        # the first three at least 200 bytes in: a boundary every x bytes
        xs = [s for s in range(200, row.blen) if KINDS[kind](states[s])][:3]
    assert len(xs) == 3, f"too few states of kind {kind}"
    _hold(args, U, xs)


def test_edge_rows():
    """A body shorter than one segment, blen <= 0, out_len 0, a row cut
    inside an escape, and the wrap row: a u32 length of 2**31 - 3, whose
    end wraps int32 and moves the position backwards; each also held to
    tpucomp's Pallas parse."""
    r = np.random.default_rng(5)
    ln = code_lengths(5)
    short, olen_s = write_stream(ln, [("lit", 65), ("lit", 66), ("lit", 67),
                                      ("match", 1, 5)])
    wrap_toks = ([("lit", 1)] * 20 + [("match", 3, 2**31)]
                 + [("lit", 2)] * 30 + [("match", 5, 20)])
    wrap, _ = write_stream(ln, wrap_toks)
    cut, olen_c = write_stream(ln, storm_tokens(r, 2000, ("u16",)))
    rows = [(short, olen_s), (table_bytes(ln), 10), (short, 0),
            (cut[:len(cut) // 2 | 1], olen_c), (wrap, 1000),
            (table_bytes(ln)[:100], 50)]
    args = _hold_to_pallas(rows, 4096)
    S, nseg = xh_parse.segments(int(args[1][0]), 5)
    assert nseg == 1 and int(args[1][0]) < S
    assert int(args[1][1]) == 0 and int(args[1][5]) < 0
    rounds, = _hold(args, 4096)
    assert rounds.tolist()[1] == 0 and rounds.tolist()[5] == 0
    *_, p_final, err = xh_parse.xh_parse_ref(*args, 4096)
    assert int(err[4]) == 1 and int(p_final[4]) < 0


@pytest.mark.parametrize("tier", [3, 5])
def test_storm_row_matches_pallas(tier):
    """A short storm row (1-byte, u16 and u32 escapes, far offsets) at
    width 4096: the model, with segment boundaries inside a u16 and a u32
    escape, on a pending offset and at odd word parity, against the plain
    parse; the plain parse and the model against tpucomp's Pallas
    parse."""
    r = np.random.default_rng(40 + tier)
    stream, olen = write_stream(code_lengths(tier), storm_tokens(
        r, 3500, ("u16", "esc8", "far", "u32")))
    U = 4096
    rows = [(stream, olen), (stream, U)]
    args = _hold_to_pallas(rows, U)
    assert int(args[3][0]) == tier
    states = boundary_states(Row(*(a[0].numpy() for a in args), U))
    xs = [next(s for s in range(100, len(states)) if ok(states[s]))
          for ok in KINDS.values()]
    _hold(args, U, xs)


def test_geometry_matches_kernel():
    """The geometry and constants that the wrapper and the model take
    from ``csrc/xh_parse.cu`` equal the kernel's own."""
    src = open(os.path.join(os.path.dirname(xh_parse.__file__), "csrc",
                            "xh_parse.cu")).read()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    consts.update({k: int(v) for k, v in re.findall(
        r"#define XH_(HYP\w*) (\d+)", src)})
    assert "constexpr int HYP = XH_HYP;" in src
    assert "constexpr int HYP_LO = XH_HYP_LO;" in src
    assert "constexpr int SUB = HYP;" in src
    for name in ("THREADS", "HYP", "HYP_LO", "WARM", "SEG_MIN", "REC",
                 "MIN_MATCH"):
        assert consts[name] == getattr(xh_parse, name), name
    assert "constexpr int SENT = 1 << 28;" in src and SENT == 1 << 28
    assert "constexpr int COPY_BIT = 1 << 20;" in src
    assert COPY_BIT == 1 << 20


def test_round_counts():
    """Rows whose round counts are known: a row no longer than WARM (every
    guess starts at byte 0, so round 1 is exact), a tier-3 row of 8-bit
    literals only (every boundary a word boundary whose leftover bits,
    8 to 15 of them, are the low bits of the word before: a hypothesis;
    no segment re-decoded), and the same with a 1-byte escape in segment
    0 (every later boundary at odd word parity: every later segment
    re-decoded)."""
    lits, olen = write_stream(code_lengths(5),
                              [("lit", i % 16) for i in range(40)])
    ln3 = code_lengths(3)
    t3_toks = [("lit", i % 128) for i in range(2000)]
    t3, olen3 = write_stream(ln3, t3_toks)
    t3e, olen3e = write_stream(ln3, t3_toks[:2] + [("match", 1, 20)]
                               + t3_toks[2:])
    args = rows_batch([(lits, olen), (t3, olen3), (t3e, olen3e)], 4096)
    assert int(args[1][0]) <= xh_parse.WARM
    assert args[3].tolist() == [5, 3, 3]
    nseg = xh_parse.segments(int(args[1][2]), 3)[1]
    assert nseg > xh_parse.THREADS // xh_parse.HYP // 2
    at8, mine = _hold(args, 4096, (8, None))
    assert at8[0] == 1 and mine.tolist() == [1, 0, nseg - 1]


def test_segments():
    T, H = xh_parse.THREADS, xh_parse.HYP
    assert xh_parse.segments(0, 5) == (0, 0)
    assert xh_parse.segments(-3, 3) == (0, 0)
    for blen in (1, 100, 4095, 30000, 65580, 200000):
        for ss in (3, 5, 17):
            S, nseg = xh_parse.segments(blen, ss)
            assert S % 4 == 0 and (S // 4) % 2 == 1  # banks apart
            assert nseg == -(-blen // S)
            assert nseg <= (T // H if ss == 3 else T)
            if ss != 3:
                assert S >= xh_parse.SEG_MIN

"""The skeleton walk and window emission of ``csrc/xp_parse.cu``, as a
numpy model, against the plain parse ``xp_parse.xp_parse_ref`` and
tpucomp's parse (its Pallas kernel in interpret mode and its XLA scan).

The model runs the kernel's two parts on each row:

- the skeleton walk: the byte machine's exact state carried from flag
  word to flag word.  A word of 32 literals goes with the ones after it,
  up to 32 in one step of the warp.  Any other word is walked first
  without the machine's stop checks, in rounds of the warp: lane j reads
  token j's low byte where it starts if every match before it in the
  round has 2 bytes, and the first escaped match (length field 7) ends
  the round and is taken alone.  The word stands if it ends inside the
  stream at a position within min(out_len, U) with no u32 escape;
  otherwise it is walked again from its entry with every check.  The body is read through the kernel's ring
  of two chunks (a read outside the live chunks fails), and each flag
  word's entry state (first token byte, position, nibble, flags) is kept.
  A flag word and each match are a step: the kernel's ``xp_parse.steps``.
- the emission: windows of ``WIN`` slots, each taken when the walk has
  reached a word that starts past its end (the model sees only the words
  recorded before it) or has stopped.  Each flag word that reaches into
  the window is re-walked from its entry over the window's staged body
  bytes (a read outside them fails): the last word seen with every check,
  the others without the stop checks.  Their tokens' errors make err.  The words a window takes are the
  ``CAND`` after the first one whose tokens end past the window's start,
  as the kernel counts them, and no slot is written twice.

Rows: every row of ``tests/test_torch_xp_parse.py`` and rows built for
this design (:func:`design_rows`): a stored nibble carried across a
flag-word boundary, a u16 = 0 -> u32 escape in a flag word's 32nd token,
stops inside a literal run and inside escapes, trailing bytes, out_len 0,
the u32 wrap followed by more tokens, out_len past U on a direct call,
and flag words of 32 literals only.  Every value is an integer: the
tolerance is exact equality.  The file imports neither JAX nor tpucomp
at module level: the card tests import it.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

from tpucomp_torch.kernels import xp_parse
from _threads import _one_thread  # noqa: F401

M32 = 0xFFFFFFFF
MIN_MATCH = xp_parse.MIN_MATCH
COPY_BIT = xp_parse.COPY_BIT
SENT = xp_parse.SENT
# the kernel's geometry (held to csrc/xp_parse.cu below)
THREADS = 128
EMITTERS = 96
CAND = 128
WIN = 4096
CHUNK = 2048
RING_LIVE = 2  # ring chunks a step may read (of SLOTS: the others land)
TOKEN_MAX = 10
WORD_MIN = xp_parse.WORD_MIN
WORD_MAX = 4 + 32 * TOKEN_MAX
LEAD = 336
U = 4096


def i32(x):
    """x wrapped to int32."""
    return ((x + (1 << 31)) & M32) - (1 << 31)


def clz(x):
    return 32 - x.bit_length()


def lit_count(run, s, length, p, olen, U):
    """The literals a run of ``run`` zero flag bits makes from (s, p): one
    only while s < length and p < olen; p rises to U and stays."""
    k = min(run, length - s)
    if olen <= U:
        k = min(k, olen - p)
    return max(k, 0)


CUT, DONE, U32 = range(3)


def escape_chain(body, length, t, nib_have, nib_val, checked=True):
    """The escape chain of a match whose length field is 7, after its high
    byte t: (CUT, ...) if the stream ends inside it (``checked``), else
    (DONE or U32, t at its last byte, nib_have, nib_val, m_len, err)."""
    def cut(x):
        return checked and x >= length

    if nib_have:
        nib_have, nv = 0, nib_val
    else:
        if cut(t + 1):
            return (CUT,)
        t += 1
        b = body(t)
        nib_have, nib_val, nv = 1, b >> 4, b & 15
    if nv < 15:
        return DONE, t, nib_have, nib_val, nv + 7 + MIN_MATCH, 0
    if cut(t + 1):
        return (CUT,)
    t += 1
    b = body(t)
    if b < 255:
        return DONE, t, nib_have, nib_val, b + 22 + MIN_MATCH, 0
    if cut(t + 2):
        return (CUT,)
    u16 = body(t + 1) | body(t + 2) << 8
    t += 2
    if u16:
        return DONE, t, nib_have, nib_val, u16 + MIN_MATCH, int(u16 < 22)
    if cut(t + 4):
        return (CUT,)
    u32 = body(t + 1) | body(t + 2) << 8 | body(t + 3) << 16 | body(t + 4) << 24
    return (U32, t + 4, nib_have, nib_val, (u32 + MIN_MATCH) & M32,
            int(i32(u32) < 22))


def match_token(body, length, s, p, olen, U, nib_have, nib_val,
                checked=True):
    """The match whose low byte is at s, as the byte machine takes it:
    None if the stream ends inside it (``checked``), else (s after it, p,
    nib_have, nib_val, err, slot, val)."""
    if checked and s + 1 >= length:
        return None
    tok = body(s) | body(s + 1) << 8
    t, m_len, e = s + 1, (tok & 7) + MIN_MATCH, 0
    if tok & 7 == 7:
        chain = escape_chain(body, length, t, nib_have, nib_val, checked)
        if chain[0] == CUT:
            return None
        _, t, nib_have, nib_val, m_len, e = chain
    off = (tok >> 3) + 1
    end = i32(p + m_len)
    e |= int(off > p or end > olen)
    return t + 1, min(end, U), nib_have, nib_val, e, t, COPY_BIT | off


def escape_fast(body, s, q, nib_have, nib_val):
    """The walk's escaped match (length field 7) at s without checks: q
    unclamped.  None on a u32 escape, else (s, q, nib_have, nib_val)."""
    kind, t, nib_have, nib_val, m_len, _ = escape_chain(
        body, 0, s + 1, nib_have, nib_val, checked=False)
    if kind == U32:
        return None
    return t + 1, q + m_len, nib_have, nib_val


def popc(x):
    return bin(x).count("1")


def word_checked(rb, length, olen, U, flags, st):
    """A flag word's tokens from the byte after its flags with every check
    of the byte machine; ``st`` = [s, p, nib_have, nib_val, steps] is
    updated.  Returns False if the row stops inside the word."""
    s, p, nib_have, nib_val, steps = st
    n = 32
    ok = True
    while True:
        run = min(clz(flags), n)
        k = lit_count(run, s, length, p, olen, U)
        p = min(p + k, U)
        s += k
        flags = (flags << k) & M32
        n -= k
        if n == 0:
            break
        if not (s < length and p < olen):
            ok = False
            break
        steps += 1
        got = match_token(rb, length, s, p, olen, U, nib_have, nib_val)
        if got is None:
            ok = False
            break
        s, p, nib_have, nib_val, _, _, _ = got
        flags = (flags << 1) & M32
        n -= 1
    st[:] = [s, p, nib_have, nib_val, steps]
    return ok


def skeleton_walk(body, length, olen, U, P):
    """The skeleton walk of one row (``body``: its P bytes).  Returns
    (entries, p_final, steps, s_end): entries (first token byte, p, nibble
    have << 4 | value, flags) of every flag word."""
    live = [0]  # the ring's older chunk

    def rb(x):
        assert live[0] * CHUNK <= x < (live[0] + RING_LIVE) * CHUNK, \
            "ring miss"
        return int(body[x]) if x < P else 0

    def word(x):
        return rb(x) | rb(x + 1) << 8 | rb(x + 2) << 16 | rb(x + 3) << 24

    length = min(length, P)
    q_max = min(olen, U)
    s = p = steps = nib_have = nib_val = 0
    entries = []
    stopped = False
    while s + 4 <= length and p < olen:
        steps += 1
        if s >= (live[0] + 1) * CHUNK:
            live[0] += 1
        flags = word(s)
        if flags == 0:
            # this word and the words of 32 literals after it, up to 32 at
            # once, one a lane
            f = 0
            while f < 32 and (f == 0 or word(s + WORD_MIN * f) == 0) and (
                    s + WORD_MIN * (f + 1) <= length
                    and p + 32 * (f + 1) <= q_max):
                f += 1
            if f:
                entries += [(s + WORD_MIN * j + 4, p + 32 * j,
                             nib_have << 4 | nib_val, 0) for j in range(f)]
                steps += f - 1
                s += WORD_MIN * f
                p += 32 * f
                continue
        entries.append((s + 4, p, nib_have << 4 | nib_val, flags))
        entry = [s + 4, p, nib_have, nib_val, steps]
        # rounds of the warp: lane j reads token j's low byte where it
        # starts if every match before it in the round has 2 bytes; the
        # first escaped match ends the round and is taken alone
        mr = int(f"{flags:032b}"[::-1], 2)  # token j's flag bit at bit j
        c, q, plain, s = 0, p, True, s + 4
        while True:
            match = [(mr >> j) & 1 for j in range(32)]
            start = [s + j - c + popc(mr & ((1 << j) - 1)) for j in range(32)]
            L0 = [rb(start[j]) & 7 if match[j] else 0 for j in range(32)]
            x = next((j for j in range(32) if L0[j] == 7), 32)
            q += sum(L0[j] + MIN_MATCH if match[j] else 1
                     for j in range(c, x))
            done = mr & ((1 << x) - 1)
            steps += popc(done)
            if x == 32:
                s += 32 - c + popc(mr)
                break
            s += x - c + popc(done)
            steps += 1
            got = escape_fast(rb, s, q, nib_have, nib_val)
            if got is None:
                plain = False
                break
            s, q, nib_have, nib_val = got
            mr &= ~((2 << x) - 1)
            c = x + 1
            if c == 32:
                break
        if plain and s <= length and q <= q_max:
            p = q
            continue
        stopped = not word_checked(rb, length, olen, U, flags, entry)
        s, p, nib_have, nib_val, steps = entry
        if stopped:
            break
    if not stopped and s < length and p < olen:
        steps += 1  # a flag word cut short
    assert len(entries) <= P // WORD_MIN + 2  # the wrapper's scratch
    return entries, p, steps, s


def walk_word(body, entry, length, olen, U, a, win, pos, val, written,
              checked):
    """An emitter's re-walk of one flag word from its entry state: its
    records of slots [a, a + win) into ``pos`` / ``val`` (a row's
    planes).  Without ``checked`` the stop checks are left out.  Returns
    the err of the tokens it walked."""
    err = 0
    s, p, nib, flags = entry
    nib_have, nib_val = nib >> 4, nib & 15
    n = 32
    hi = a + win
    while True:
        run = min(clz(flags), n)
        k = lit_count(run, s, length, p, olen, U) if checked else run
        j0, j1 = max(0, a - s), min(k, hi - s)
        if j1 > j0:
            sl = slice(s + j0, s + j1)
            assert not written[sl].any()
            written[sl] = True
            pos[sl] = np.minimum(p + np.arange(j0, j1), U)
            val[sl] = [body(x) for x in range(s + j0, s + j1)]
        p = min(p + k, U)
        s += k
        flags = (flags << k) & M32
        n -= k
        if n == 0 or s >= hi:
            return err
        if checked and not (s < length and p < olen):
            return err
        p0 = p
        got = match_token(body, length, s, p, olen, U, nib_have, nib_val,
                          checked)
        if got is None:
            return err
        s, p, nib_have, nib_val, e, slot, v = got
        err |= e
        if a <= slot < hi:
            assert not written[slot]
            written[slot] = True
            pos[slot], val[slot] = p0, v
        flags = (flags << 1) & M32
        n -= 1


def emit(body, length, olen, U, P, entries, s_end, win=WIN):
    """The emission of one row: its (rec_pos, rec_val) planes and err, the
    err of every token the emitters walk."""
    err = 0
    length = min(length, P)
    pos = np.full(P, SENT, np.int64)
    val = np.zeros(P, np.int64)
    written = np.zeros(P, bool)
    nw = len(entries)
    first = [e[0] - 4 for e in entries]  # each flag word's first byte
    end = first[1:] + [s_end]  # its tokens fill [entry, end)
    w0 = 0
    for a in range(0, P, win):
        base = a - LEAD

        def wb(x, base=base):
            assert base <= x < base + LEAD + win + 16, "window miss"
            return int(body[x]) if 0 <= x < P else 0

        # what the walk has published when it reaches the first word past
        # the window's end (the words before it, and its first byte as the
        # edge where their tokens end); all of it once it has stopped
        past = [w for w in range(nw) if first[w] >= a + win]
        seen = past[0] if past else nw
        edge = first[past[0]] if past else s_end
        seen_end = end[:seen - 1] + [edge] if seen else []
        cand = range(w0, min(w0 + CAND, seen))
        reach = [w for w in cand if seen_end[w] > a and first[w] < a + win]
        assert reach == [w for w in range(w0, nw)
                         if end[w] > a and first[w] < a + win]
        for w in reach:  # the last word seen with every check
            err |= walk_word(wb, entries[w], length, olen, U, a, win, pos,
                             val, written, checked=w == seen - 1)
        passed = sum(seen_end[w] <= a + win for w in cand)
        assert passed == sum(end[w] <= a + win for w in range(w0, nw))
        w0 += passed
    return pos, val, err


def walk_rows(payload, plen, out_len, U, win=WIN):
    """The kernel's parse of a batch (numpy [N, P] bytes): (rec_pos,
    rec_val, p_final, err, steps) as int32 numpy arrays."""
    payload = np.asarray(payload)
    N, P = payload.shape
    out = [np.zeros((N, P), np.int32), np.zeros((N, P), np.int32)] + [
        np.zeros(N, np.int32) for _ in range(3)]
    for n in range(N):
        body = payload[n]
        entries, p, steps, s_end = skeleton_walk(
            body, int(plen[n]), int(out_len[n]), U, P)
        out[0][n], out[1][n], out[3][n] = emit(
            body, int(plen[n]), int(out_len[n]), U, P, entries, s_end, win)
        out[2][n], out[4][n] = p, steps
    return out


def walk_steps(payload, plen, out_len, U):
    """The skeleton walk's step count of each row (the kernel's
    ``xp_parse.steps``)."""
    payload = np.asarray(payload)
    return np.array([skeleton_walk(payload[n], int(plen[n]), int(out_len[n]),
                                   U, payload.shape[1])[2]
                     for n in range(payload.shape[0])], np.int32)


def entries_of(stream, olen, U=U):
    """The flag words' entry states of one stream."""
    body = np.frombuffer(stream, np.uint8)
    return skeleton_walk(body, len(stream), olen, U, len(body))[0]


# ---- streams written token by token ----------------------------------------

def write_stream(tokens):
    """An Xpress stream of hand-chosen tokens, as [MS-XCA] 2.3 writes them:
    ("lit", byte); ("match", offset, length) with the format's escapes (a
    shared nibble byte, then a byte, u16 or u32); ("u32", offset, value),
    a match whose length goes through the u16 = 0 -> u32 escape whatever
    the value (its length is value + 3, wrapping int32).  Unused flag bits
    of the last word are 1s.  Returns (stream, ends): ends[i] is the index
    of token i's last byte, the record slot the parse gives it."""
    out = bytearray()
    flag_at, flags, nflags, nib_at = None, 0, 0, -1
    ends = []

    def flag(bit):
        nonlocal flag_at, flags, nflags
        if flag_at is None:
            flag_at = len(out)
            out.extend(bytes(4))
        flags = flags << 1 | bit
        nflags += 1

    def close():
        nonlocal flag_at, flags, nflags
        if flag_at is not None:
            rem = 32 - nflags
            word = (flags << rem | ((1 << rem) - 1)) & M32
            out[flag_at:flag_at + 4] = word.to_bytes(4, "little")
            flag_at, flags, nflags = None, 0, 0

    def nibble(v):
        nonlocal nib_at
        if nib_at < 0:
            nib_at = len(out)
            out.append(v)
        else:
            out[nib_at] |= v << 4
            nib_at = -1

    for tok in tokens:
        if tok[0] == "lit":
            flag(0)
            out.append(tok[1])
        else:
            flag(1)
            off = tok[1]
            L = 7 if tok[0] == "u32" else min(tok[2] - MIN_MATCH, 7)
            out += (((off - 1) << 3) | L).to_bytes(2, "little")
            if tok[0] == "u32":
                nibble(15)
                out += bytes([255, 0, 0]) + (tok[2] & M32).to_bytes(4,
                                                                      "little")
            elif L == 7:
                rest = tok[2] - MIN_MATCH - 7
                nibble(min(rest, 15))
                if rest >= 15:
                    if rest - 15 < 255:
                        out.append(rest - 15)
                    else:
                        full = tok[2] - MIN_MATCH
                        out.append(255)
                        out += (full if full < 1 << 16 else 0).to_bytes(
                            2, "little")
                        if full >= 1 << 16:
                            out += full.to_bytes(4, "little")
        ends.append(len(out) - 1)
        if nflags == 32:
            close()
    close()
    return bytes(out), ends


def literals(n, seed=0):
    r = np.random.default_rng(seed)
    return [("lit", int(b)) for b in r.integers(0, 256, n)]


def out_size(tokens):
    return sum(1 if t[0] == "lit" else
               (t[2] + MIN_MATCH if t[0] == "u32" else t[2]) for t in tokens)


def design_rows():
    """{kind: (stream, plen, out_len)}: rows built for the walk's edges,
    all parsed at U = 4096 (one of them with out_len past U)."""
    rows = {}
    # a nibble byte's high half waits across a flag-word boundary, once
    # for a length (5) and once for an escape (15, then a byte)
    toks = (literals(31, 1) + [("match", 1, 12), ("match", 2, 15)]
            + literals(30, 2) + [("match", 1, 10), ("match", 3, 80)]
            + literals(40, 3))
    s, _ = write_stream(toks)
    rows["nibble across words"] = (s, len(s), out_size(toks))
    # a u16 = 0 -> u32 escape in a flag word's 32nd token, its nibble a
    # fresh byte and then a pending high half
    toks = (literals(31, 4) + [("u32", 1, 297)] + literals(30, 5)
            + [("match", 4, 11), ("u32", 2, 1000)] + literals(10, 6))
    s, _ = write_stream(toks)
    rows["u32 in a 32nd token"] = (s, len(s), out_size(toks))
    # stops inside a literal run: by out_len, and by the stream's end
    toks = literals(100, 7) + [("match", 9, 40)]
    s, ends = write_stream(toks)
    rows["out_len inside a run"] = (s, len(s), 45)
    rows["stream ends inside a run"] = (s, ends[70], 140)
    # stops inside escapes: the u16 and the u32 bytes, and a flag word
    toks = (literals(20, 8) + [("match", 3, 400), ("lit", 5),
                            ("match", 2, 70000)] + literals(12, 9))
    s, ends = write_stream(toks)
    rows["stream ends inside a u16"] = (s, ends[20], U)
    rows["stream ends inside a u32"] = (s, ends[22] - 1, U)
    s2, ends2 = write_stream(literals(40, 10))
    rows["stream ends inside a flag word"] = (s2, ends2[31] + 3, 40)
    # trailing bytes past out_len, and out_len 0
    toks = literals(50, 11) + [("match", 7, 30)] + literals(20, 12)
    s, _ = write_stream(toks)
    junk = bytes(np.random.default_rng(13).integers(0, 256, 60,
                                                    dtype=np.uint8))
    rows["trailing bytes"] = (s + junk, len(s) + 60, out_size(toks))
    rows["out_len 0"] = (s, len(s), 0)
    # the u32 wrap (2^31 - 3 + 3 wraps to -2^31), then literals at
    # negative positions and a match that sets err
    toks = ([("lit", 7), ("u32", 1, (1 << 31) - 3)] + literals(40, 14)
            + [("match", 1, 5)] + literals(3, 15))
    s, _ = write_stream(toks)
    rows["wrap then more tokens"] = (s, len(s), 4096)
    # out_len past U (a direct call): positions clamp at U, so out_len
    # never stops the walk; the stream ends with its last flag word's 32nd
    # token, so that no check of the stream's end clamps the position
    toks = literals(5000, 16) + [("match", 3, 500)] + literals(23, 17)
    assert len(toks) % 32 == 0
    s, _ = write_stream(toks)
    rows["out_len past U"] = (s, len(s), 6000)
    # flag words of 32 literals only (random bytes)
    s, _ = write_stream(literals(U, 18))
    rows["32 literals a word"] = (s, len(s), U)
    return rows


def pack(rows):
    """(stream, plen, out_len) rows -> numpy (payload uint8 [N, P], plen,
    out_len), P the longest stream rounded up to 16."""
    P = -(-max(len(s) for s, _, _ in rows) // 16) * 16
    payload = np.zeros((len(rows), P), np.uint8)
    for k, (s, _, _) in enumerate(rows):
        payload[k, :len(s)] = np.frombuffer(s, np.uint8)
    plen = np.array([n for _, n, _ in rows], np.int32)
    olen = np.array([o for _, _, o in rows], np.int32)
    return payload, plen, olen


# ---- the tests -------------------------------------------------------------

def _plain(payload, plen, olen, U):
    return [a.numpy() for a in xp_parse.xp_parse_ref(
        torch.from_numpy(payload), torch.from_numpy(plen),
        torch.from_numpy(olen), U)]


def hold_to_tpucomp(payload, plen, olen, U, got, monkeypatch, wrap=()):
    """The model's output ``got`` against tpucomp's Pallas parse in
    interpret mode and its XLA scan: p_final and err on every row, the
    records filled (the slot layouts differ) on every row, but for the
    Pallas kernel on rows ``wrap``, whose negative positions its packed
    plane cannot hold."""
    import jax.numpy as jnp
    from tpucomp.codecs import xpress as t_xp
    from tpucomp.kernels import common as t_common
    from tpucomp.kernels import xp_pallas

    from tpucomp_torch.kernels import fill

    def filled(pos, val):
        return [np.asarray(a) for a in t_common.fill_records_delta2(
            jnp.asarray(pos), jnp.asarray(val), U)[:2]]

    mine = [a.numpy() for a in fill.fill_records_delta2_ref(
        torch.from_numpy(got[0]), torch.from_numpy(got[1]), U)[:2]]
    args = [jnp.asarray(payload.astype(np.int32)), jnp.asarray(plen),
            jnp.asarray(olen)]
    t_pal = [np.array(a) for a in xp_pallas.parse_records(*args, U,
                                                          interpret=True)]
    monkeypatch.setattr(t_xp, "_records_to_output", lambda *a, **k: a[:4])
    t_xla = [np.array(a) for a in t_xp._decode_impl(*args, U)]
    keep = ~np.isin(np.arange(len(plen)), wrap)
    for (t_pos, t_val, t_p, t_err), rows in ((t_pal, keep),
                                             (t_xla, slice(None))):
        np.testing.assert_array_equal(got[2], t_p)
        np.testing.assert_array_equal(got[3], t_err)
        for g, w in zip(mine, filled(t_pos, t_val)):
            np.testing.assert_array_equal(g[rows], w[rows])


def hold_to_plain(payload, plen, olen, U, win=WIN):
    """The model against the plain parse: every slot, p_final and err."""
    got = walk_rows(payload, plen, olen, U, win)
    for g, w in zip(got, _plain(payload, plen, olen, U)):
        np.testing.assert_array_equal(g, w)
    return got


@functools.lru_cache(maxsize=None)
def _design():
    """The rows built for the walk, packed: their kinds, the batch, the
    model's output and the plain parse's."""
    rows = design_rows()
    batch = pack(list(rows.values()))
    return list(rows), batch, walk_rows(*batch, U), _plain(*batch, U)


def test_model_on_the_xp_parse_rows(monkeypatch):
    """Every row of tests/test_torch_xp_parse.py (tpucomp, oracle and
    native C units, every escape, malformed rows, the wrap row): the model
    against the plain parse slot for slot, at the kernel's window and at
    two narrow ones, and against tpucomp's Pallas parse and XLA scan."""
    from test_torch_xp_parse import WRAP_ROW, _batch  # imports JAX

    payload, plen, olen, _ = _batch()
    payload = payload.astype(np.uint8)
    got = hold_to_plain(payload, plen, olen, U)
    for win in (64, 1040):
        hold_to_plain(payload, plen, olen, U, win)
    hold_to_tpucomp(payload, plen, olen, U, got, monkeypatch,
                    wrap=[len(plen) + WRAP_ROW])


@pytest.mark.parametrize("kind", sorted(design_rows()))
def test_design_row(kind, monkeypatch):
    """Each row built for the walk's edges: the model (run on all of them
    at once) against the plain parse, slot for slot, and against tpucomp's
    Pallas parse and XLA scan on this row."""
    kinds, (payload, plen, olen), got, want = _design()
    k = kinds.index(kind)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[k], w[k])
    one = [a[k:k + 1] for a in (payload, plen, olen)]
    hold_to_tpucomp(*one, U, [g[k:k + 1] for g in got], monkeypatch,
                    wrap=[0] if kind == "wrap then more tokens" else [])
    stream, n, o = design_rows()[kind]
    p, err, steps = (int(g[k]) for g in got[2:])
    if kind == "nibble across words":
        ents = entries_of(stream, o)
        assert [e[2] for e in ents[:3]] == [0, 1 << 4 | 5, 1 << 4 | 15]
        assert (p, err) == (o, 0)
    elif kind == "u32 in a 32nd token":
        _, ends = write_stream(literals(31, 4) + [("u32", 1, 297)])
        assert entries_of(stream, o)[1][0] - 4 == ends[31] + 1
        assert (p, err) == (o, 0)
    elif kind == "out_len inside a run":
        assert (p, err, steps) == (45, 0, 2)
    elif kind == "stream ends inside a run":
        assert (p, err, steps) == (70, 0, 3)
    elif kind in ("stream ends inside a u16", "stream ends inside a u32"):
        assert err == 0 and p == 20 + (400 + 1 if "u32" in kind else 0)
    elif kind == "stream ends inside a flag word":
        assert (p, steps) == (32, 2)
    elif kind == "trailing bytes":
        assert (p, err) == (o, 0)
    elif kind == "out_len 0":
        assert (p, err, steps) == (0, 0, 0)
        assert (got[0][k] == SENT).all()
    elif kind == "wrap then more tokens":
        assert err == 1 and p == 1 - (1 << 31) + 40 + 5 + 3
    elif kind == "out_len past U":
        assert (p, err) == (U, 0) and o > U
    else:
        assert (p, err, steps) == (U, 0, U // 32)


@pytest.mark.parametrize("win", [64, 1040])
def test_design_rows_at_narrow_windows(win):
    """The rows built for the walk at two other window widths: a word
    spans several windows at 64, and 1040 is not a power of two."""
    _, (payload, plen, olen), _, _ = _design()
    hold_to_plain(payload, plen, olen, U, win)


def test_writer_escapes():
    """The writer's streams hold what the rows rely on: a nibble byte
    shared across a flag-word boundary, and a u32 escape whose u16 is 0."""
    s, ends = write_stream(literals(31) + [("match", 1, 12), ("match", 2, 15)])
    assert s[ends[31]] == 0x52 and ends[32] == ends[31] + 6  # hi nibble 5
    s, ends = write_stream([("lit", 1), ("u32", 1, 297)])
    assert s[ends[1] - 7:ends[1] + 1] == bytes([15, 255, 0, 0, 41, 1, 0, 0])


def test_steps():
    """The walk's step count: a flag word and each match is a step, a run
    of literals rides on the step before it."""
    toks = literals(10) + [("match", 1, 5)] * 3 + literals(19) + literals(32) + [
        ("match", 2, 9)]
    s, _ = write_stream(toks)
    payload, plen, olen = pack([(s, len(s), out_size(toks)),
                                (s, len(s), 10), (s, 0, 10)])
    assert walk_steps(payload, plen, olen, U).tolist() == [3 + 4, 1, 0]


def test_geometry_matches_kernel():
    """The constants that the model and the wrapper mirror equal the
    kernel's own."""
    src = open(os.path.join(os.path.dirname(xp_parse.__file__), "csrc",
                            "xp_parse.cu")).read()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    mine = dict(THREADS=THREADS, EMITTERS=EMITTERS, CAND=CAND, WIN=WIN,
                CHUNK=CHUNK, SLOTS=2 * RING_LIVE, TOKEN_MAX=TOKEN_MAX,
                WORD_MIN=WORD_MIN, WORD_MAX=WORD_MAX, LEAD=LEAD,
                MIN_MATCH=MIN_MATCH)
    for name, v in mine.items():
        assert consts[name] == v, name
    assert "constexpr int SENT = 1 << 28;" in src and SENT == 1 << 28
    assert "constexpr int COPY_BIT = 1 << 20;" in src
    assert COPY_BIT == 1 << 20
    assert "constexpr int BODY_WIN = LEAD + WIN + 16;" in src
    assert "int4* entries" in src and xp_parse.ENTRY == 4
    assert "max_words" in src


def test_convergence_model():
    """scripts/xp_convergence.py, the CPU model behind the kernel's note
    on speculative segments, on one unit of its corpus: its count of flag
    words and matches is the walk's steps, and guesses from a fresh flag
    word miss the true path for more than 8 KB."""
    import importlib.util

    from benchmarks.corpus import silesia_like
    from tpucomp import _native

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "xp_convergence", os.path.join(root, "scripts", "xp_convergence.py"))
    conv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conv)
    unit = silesia_like(8 << 20)[24 << 16:25 << 16]  # its unit 24
    s = _native.xpress_compress(unit)
    tokens, matches, words, meets = conv.unit_counts(s, len(unit))
    payload, plen, olen = pack([(s, len(s), len(unit))])
    assert walk_steps(payload, plen, olen, 1 << 16).tolist() == [
        words + matches]
    assert (tokens, matches, words) == (12202, 7258, 382)
    assert len(meets) == 21 and meets.count(None) == 11

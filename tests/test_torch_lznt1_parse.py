"""The LZNT1 parse of ``csrc/lznt1_parse.cu`` as a numpy model, against
the plain parse ``lznt1_parse.lznt1_parse_ref`` and tpucomp's Pallas
``parse_records`` (interpret mode).

The kernel gives a warp a chunk and walks its tokens in windows of 32,
one a lane.  :func:`walk` does what it does, for all rows at once: the
chain of group starts from the window's first group, each token's byte
offset, kind and length under the band of the window's first output
position, the scan of start positions, the first token out of that band
(the next window starts there: a redone window) or at which the walk
stops (at or past ``len``, at p >= 4096, a copy cut after its lo byte),
the span writes, then the row's tail.  Bytes past what the kernel stages
hold garbage in the model, as stale shared memory does in the kernel, and
a read past the kernel's slice of shared memory raises.
It counts each row's windows and redone windows, and how often each
record slot was written (once, every slot).

The rows of :data:`CASES` are written token by token to sit on the walk's
edges; the card tests in ``tests/test_torch_cuda.py`` run them through
the kernel (they import :func:`case_rows` and :func:`walk` by module
name).  Every value is an integer: the tolerance is exact equality.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

from tpucomp_torch.kernels import lznt1_parse as lp

U = lp.U
SENT, EMPTY_VAL, COPY_BIT = lp.SENT, lp.EMPTY_VAL, lp.COPY_BIT
STAGE = 4616  # payload bytes the kernel stages a chunk
SLICE = 4704  # bytes a window may read: the kernel's slice less its shift
WIDTHS = (4616, 4613, 1001)  # the batch's payload pad; an odd one; < U
EDGES = (16, 32, 64, 128, 256, 512, 1024, 2048)  # last p of each band
POPC = np.array([bin(v).count("1") for v in range(256)], np.int64)
LANES = np.arange(32)


def d_shift(p):
    """A copy's displacement shift at output position p (int arrays)."""
    q = np.maximum(np.asarray(p, np.int64) - 1, 0)
    bitlen = np.frexp(q.astype(np.float64))[1]
    return 12 - np.maximum(bitlen - 4, 0)


def walk(payload, plen, is_comp, garbage=0):
    """The kernel's walk on a batch: payload uint8 [N, P], plen int [N],
    is_comp bool [N] -> (rec_pos [N, P], rec_val [N, P], p_final [N],
    err [N], windows [N, 2]: each row's windows and redone windows,
    writes [N, P]: how often each record slot was written)."""
    payload = np.asarray(payload, np.uint8)
    N, P = payload.shape
    ln = np.where(is_comp, np.clip(plen, 0, P), 0).astype(np.int64)
    # the slice: the first min(len, STAGE) bytes, then garbage
    B = np.random.default_rng(garbage).integers(0, 256, (N, SLICE))
    w = min(P, STAGE)
    B[:, :w] = np.where(np.arange(w) < ln[:, None], payload[:, :w], B[:, :w])
    rec_pos = np.zeros((N, P), np.int64)
    rec_val = np.zeros((N, P), np.int64)
    writes = np.zeros((N, P), np.int64)

    def write(rows, at, pos, val, mask):
        rows, at, pos, val = (np.broadcast_to(x, mask.shape)[mask]
                              for x in (rows, at, pos, val))
        rec_pos[rows, at] = pos
        rec_val[rows, at] = val
        np.add.at(writes, (rows, at), 1)

    g, j0, p, end = (np.zeros(N, np.int64) for _ in range(4))
    err = np.zeros(N, bool)
    windows = np.zeros((N, 2), np.int64)
    live = ln > 0
    while live.any():
        r = np.flatnonzero(live)
        rr, at = r[:, None], np.arange(len(r))
        windows[r, 0] += 1
        t = j0[rr] + LANES
        k, jj = t >> 3, t & 7
        G = [g[r]]
        f = [B[r, G[0]]]
        for _ in range(4):
            G.append(G[-1] + 9 + POPC[f[-1]])
            f.append(B[r, G[-1]])
        G, f = np.stack(G, 1), np.stack(f, 1)
        Gk, fk = np.take_along_axis(G, k, 1), np.take_along_axis(f, k, 1)
        ts = Gk + 1 + jj + POPC[fk & ((1 << jj) - 1)]
        cp = ((fk >> jj) & 1).astype(bool)
        lo = B[rr, ts]
        word = lo | (B[rr, ts + 1] << 8)
        dsh = d_shift(p[r])[:, None]
        length = np.where(cp, (word & ((1 << dsh) - 1)) + 3, 1)
        incl = np.cumsum(length, 1)
        sp = p[rr] + incl - length
        L = ln[rr]
        stop = (ts >= L) | (sp >= U) | (cp & (ts + 1 >= L))
        first = stop | (sp > (1 << (16 - dsh)))
        e = np.where(first.any(1), first.argmax(1), 32)
        acc = LANES < e[:, None]
        disp = (word >> dsh) + 1
        slot = ts + cp
        write(rr, slot, sp, np.where(cp, COPY_BIT | disp, lo), acc)
        write(rr, ts, SENT, EMPTY_VAL, acc & cp)
        write(rr, Gk, SENT, EMPTY_VAL, acc & (jj == 0))
        err[r] |= (acc & cp & ((disp > sp) | (sp + length > U))).any(1)
        end[r] = np.where(e > 0, slot[at, np.maximum(e - 1, 0)] + 1, end[r])
        full = e == 32
        e = np.minimum(e, 31)
        stopped = ~full & stop[at, e]
        err[r] |= stopped & cp[at, e] & (ts[at, e] < L[:, 0]) & (sp[at, e] < U)
        redo = ~full & ~stopped
        windows[r, 1] += redo
        p[r] = np.where(full, p[r] + incl[:, 31], sp[at, e])
        g[r] = np.where(full, G[:, 4], np.where(redo, Gk[at, e], g[r]))
        j0[r] = np.where(redo, jj[at, e], j0[r])
        live[r] = np.where(full, (p[r] < U) & (g[r] < L[:, 0]), redo)
    tail = np.arange(P) >= end[:, None]
    rec_pos[tail], rec_val[tail] = SENT, EMPTY_VAL
    writes += tail
    return (rec_pos, rec_val, np.minimum(p, U), err.astype(np.int64),
            windows, writes)


# ---- rows written token by token ------------------------------------------


def write_tokens(tokens):
    """An LZNT1 chunk payload from tokens: an int is a literal byte, a
    (disp, length) pair a copy, coded at the position it starts (fields
    need not be valid: past U, disp > p).  Returns (bytes, the byte offset
    of each token, of each group's flag byte)."""
    out, starts, flags, p = bytearray(), [], [], 0
    for k, tok in enumerate(tokens):
        if k % 8 == 0:
            flags.append(len(out))
            out.append(0)
        starts.append(len(out))
        if isinstance(tok, tuple):
            disp, length = tok
            dsh = int(d_shift(p))
            assert 1 <= disp <= 1 << (16 - dsh)
            assert 3 <= length <= (1 << dsh) + 2
            out += (((disp - 1) << dsh) | (length - 3)).to_bytes(2, "little")
            out[flags[-1]] |= 1 << (k % 8)
            p += length
        else:
            out.append(tok)
            p += 1
    return bytes(out), starts, flags


def lits(n, seed=0):
    return [int(b) for b in np.random.default_rng(seed).integers(0, 256, n)]


def top_bit_copy(p, disp):
    """A copy at p whose length field has only its top bit set: a band off
    by one reads another length and displacement."""
    return (disp, 3 + (1 << (int(d_shift(p)) - 1)))


def _band_edges():
    """Copies that start at each side of every band edge (p = E and
    E + 1), and ones whose own length ends on either side of it."""
    rows = []
    for E in EDGES:
        for s in (E, E + 1):
            toks = lits(s, s) + [top_bit_copy(s, s), (1, 3)] + lits(40, E)
            rows.append(write_tokens(toks)[0])
            toks = lits(s - 5, E) + [(1, 5), top_bit_copy(s, s)] + lits(9, s)
            rows.append(write_tokens(toks)[0])
    return [(b, len(b), True) for b in rows]


def _band_jumps():
    """A copy whose own length carries p across several band edges."""
    rows = [lits(5) + [(5, 3000)] + lits(10) + [(100, 10)] + lits(30),
            lits(1) + [(1, 2047)] + [(600, 17)] + lits(50),
            [0x41, (1, 4095)] + lits(20),  # to exactly U, then ignored
            lits(17) + [(17, 1025)] + [top_bit_copy(1042, 1000)] + lits(33)]
    return [(b, len(b), True) for b in (write_tokens(t)[0] for t in rows)]


def _full_output():
    """p reaching exactly U, by literals or by a copy, and copies past U
    (err, p_final = U); the bytes after are ignored (a copy at p = 0
    among them)."""
    after = [(1, 3), (9, 3)] + lits(20)
    rows = [lits(4080) + [(1, 16)] + after,
            lits(4090) + [(1, 10)] + after,  # past U
            lits(1) + [(1, 4098)] + after,  # past U from the first band
            lits(4095) + [(1, 3)] + after]  # past U by 2 at the last p
    return [(b, len(b), True) for b in (write_tokens(t)[0] for t in rows)]


def _all_literal():
    """4096 literals in 512 groups; one row with more bytes after (not
    parsed), one ending on the last literal."""
    b = write_tokens(lits(4096, 7))[0]
    return [(b, len(b), True), (b + bytes(8), len(b) + 8, True)]


def _stream_ends():
    """Streams cut after a copy's lo byte (err), after a flag byte (no
    err) and after any token of a group (no err), token j = 0..7."""
    rows = []
    for j in range(8):
        toks = lits(40 + j, j) + [(3, 4)] + lits(12, j)
        b, starts, flags = write_tokens(toks)
        rows.append((b, starts[40 + j] + 1, True))  # lo byte last
        rows.append((b, starts[40 + j] + 2, True))  # the copy complete
        rows.append((b, flags[5 + (j > 0)] + 1, True))  # flag byte last
        toks = lits(16, j) + [(2, 3)] * (j + 1) + lits(12, j)
        b, starts, _ = write_tokens(toks)
        rows.append((b, starts[16 + j] + 2, True))  # cut after token j
    return rows


def _disp_past_p():
    """A first token that copies (disp 1 > p = 0: err, record kept), and
    copies reaching before the chunk later on."""
    rows = [[(1, 3)] + lits(10), [(1, 4098)], lits(5) + [(9, 3)] + lits(4),
            lits(40) + [(41, 20), (1, 3)] + lits(3)]
    return [(b, len(b), True) for b in (write_tokens(t)[0] for t in rows)]


def _stored_and_lengths():
    """Stored rows (all empty), plen 0 and negative, plen past P."""
    r = np.random.default_rng(5)
    rnd = [r.integers(0, 256, 4616, dtype=np.uint8).tobytes()
           for _ in range(4)]
    good = write_tokens(lits(300) + [(7, 30)] + lits(700))[0]
    return [(rnd[0], 4096, False), (good, len(good), False), (rnd[1], 0, True),
            (rnd[2], -5, True), (good + rnd[3], 5000, True),
            (rnd[3], 1 << 20, True)]


def _random_bytes():
    """Random bytes parsed as tokens: most rows malformed."""
    r = np.random.default_rng(6)
    return [(r.integers(0, 256, n, dtype=np.uint8).tobytes(), n, True)
            for n in (1, 2, 3, 9, 17, 300, 1447, 4096, 4608, 4609, 4616)]


def _native():
    """Chunks of text-like data by the repo's native C encoder."""
    from chip_smoke import Native
    from tpucomp_torch.codecs import lznt1 as lz

    r = np.random.default_rng(8)
    words = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps ", b"over ",
             b"lazy ", b"dog. ", b"\n"]
    text = b"".join(words[i] for i in r.integers(0, len(words), 9000))
    data = (text[:20000] + r.integers(0, 256, 3000, dtype=np.uint8).tobytes()
            + bytes(5000) + text[20000:32000] + b"ab" * 3000)
    payloads, comps = lz.split_stream(Native().lznt1_compress(data))
    return [(pl, len(pl), c) for pl, c in zip(payloads, comps)]


CASES = {
    "band_edges": _band_edges, "band_jumps": _band_jumps,
    "full_output": _full_output, "all_literal": _all_literal,
    "stream_ends": _stream_ends, "disp_past_p": _disp_past_p,
    "stored_and_lengths": _stored_and_lengths, "random_bytes": _random_bytes,
    "native": _native,
}


@functools.lru_cache(maxsize=None)
def _case(name):
    return CASES[name]()


def case_rows(name, P):
    """Case ``name`` at payload width P: (payload uint8 [n, P], plen int32
    [n], is_comp bool [n]) numpy arrays; bytes past P are cut."""
    rows = _case(name)
    payload = np.zeros((len(rows), P), np.uint8)
    for k, (b, _, _) in enumerate(rows):
        b = np.frombuffer(b[:P], np.uint8)
        payload[k, :len(b)] = b
    return (payload, np.array([n for _, n, _ in rows], np.int32),
            np.array([c for _, _, c in rows], bool))


@functools.lru_cache(maxsize=None)
def _plain(P):
    """The plain parse of every case's rows at width P, and the row each
    case starts at."""
    parts = [case_rows(name, P) for name in CASES]
    starts = np.cumsum([0] + [len(x[1]) for x in parts])
    batch = [torch.from_numpy(np.concatenate(x)) for x in zip(*parts)]
    return [t.numpy() for t in lp.lznt1_parse_ref(*batch)], starts


def records(rec_pos):
    """[n]: each row's records (the tokens the walk accepted)."""
    return (rec_pos != SENT).sum(1)


def bands(rec_pos):
    """[n]: how many bands each row's record positions touch."""
    b = np.where(rec_pos != SENT, d_shift(rec_pos), -1)
    return np.array([len(set(row[row >= 0].tolist())) for row in b])


# each case's windows and redone windows at P = 4616, summed over rows
WINDOWS = {"band_edges": (596, 80), "band_jumps": (12, 5),
           "full_output": (388, 6), "all_literal": (258, 4),
           "stream_ends": (89, 57), "disp_past_p": (7, 3),
           "stored_and_lengths": (65, 6), "random_bytes": (85, 17),
           "native": (245, 66)}


@pytest.mark.parametrize("P", WIDTHS)
@pytest.mark.parametrize("name", list(CASES))
def test_model_matches_plain(name, P):
    want, starts = _plain(P)
    k = list(CASES).index(name)
    want = [w[starts[k]:starts[k + 1]] for w in want]
    *got, windows, writes = walk(*case_rows(name, P))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (writes == 1).all()  # every slot written, and once
    # a full window accepts 32 tokens, a redone one at least 1, and only
    # the last window of a row may be neither; each redone window starts
    # in a later band that holds a record
    nrec, nwin, nredo = records(want[0]), windows[:, 0], windows[:, 1]
    assert (nwin * 32 >= nrec).all()
    assert (nwin - nredo <= nrec // 32 + 1).all()
    assert (nredo <= np.maximum(bands(want[0]) - 1, 0)).all()
    assert (nredo <= 8).all()
    if P == 4616 and name in WINDOWS:
        assert tuple(windows.sum(0)) == WINDOWS[name]


def test_windows_of_the_edge_rows():
    """4096 literals: a window for p 0..16, one for 17..32 (both cut by
    the band: redone after them), then 127 more from p = 33, the last
    stopping at p = U.  A copy across eight bands needs no redone window
    when the walk stops after it.  16 literals, a copy at p = 16 to p =
    2067, 41 tokens: the copy is in the first window, the tokens after it
    redone; the same copy at p = 17 starts a redone window itself."""
    *_, windows, _ = walk(*case_rows("all_literal", 4616))
    assert windows.tolist() == [[129, 2], [129, 2]]
    *_, windows, _ = walk(*case_rows("band_jumps", 4616))
    assert windows[2].tolist() == [1, 0]  # [literal, copy to U]: one window
    *_, windows, _ = walk(*case_rows("band_edges", 4616))
    assert windows[0].tolist() == [3, 1] and windows[2].tolist() == [4, 2]
    *_, windows, _ = walk(*case_rows("stored_and_lengths", 4616))
    assert windows[:4].tolist() == [[0, 0]] * 4  # stored, plen <= 0


def test_stage_garbage_is_never_read():
    """Other garbage in the unstaged bytes gives the same walk."""
    rows = case_rows("random_bytes", 4616)
    a, b = walk(*rows, garbage=1), walk(*rows, garbage=2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_native_and_oracle_chunks_of_the_kernel_tests():
    """The model on test_torch_kernels.py's PARSE_CASES (native, oracle,
    stored and malformed chunks) against the plain parse."""
    from test_torch_kernels import PARSE_CASES, _batch

    batch = [np.concatenate(x) for x in zip(
        *(_batch(PARSE_CASES[c]) for c in sorted(PARSE_CASES)))]
    want = lp.lznt1_parse_ref(*(torch.from_numpy(x) for x in (
        batch[0].astype(np.uint8), batch[1], batch[2])))
    *got, windows, writes = walk(batch[0].astype(np.uint8), *batch[1:])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert (writes == 1).all() and (windows[:, 1] <= 8).all()


def test_edge_rows_match_pallas():
    """A batch of the edge rows against tpucomp's Pallas parse in
    interpret mode (16 rows: one compile)."""
    import jax.numpy as jnp
    from tpucomp.kernels import lznt1_pallas

    P = 4616
    pick = [("band_edges", 0), ("band_edges", 15), ("band_jumps", 0),
            ("full_output", 0), ("full_output", 1), ("all_literal", 0),
            ("stream_ends", 0), ("stream_ends", 2), ("stream_ends", 31),
            ("disp_past_p", 0), ("stored_and_lengths", 1),
            ("stored_and_lengths", 4), ("random_bytes", 6),
            ("random_bytes", 9), ("native", 0), ("native", 4)]
    rows = [[x[i] for x in case_rows(name, P)] for name, i in pick]
    payload, plen, is_comp = (np.stack(x) for x in zip(*rows))
    plen = np.minimum(plen, P)  # Pallas reads no further than the payload
    out = lznt1_pallas.parse_records(
        jnp.asarray(payload.astype(np.int32)), jnp.asarray(plen),
        jnp.asarray(is_comp), U, interpret=True)
    want = [np.asarray(a) for a in out]
    got = walk(payload, plen, is_comp)
    np.testing.assert_array_equal(got[0], want[0][:, :P])
    np.testing.assert_array_equal(got[1], want[1][:, :P])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


def test_kernel_constants():
    """The kernel's constants are the wrapper's and the model's, and
    BLOCKS_PER_SM blocks of WARPS slices fit an SM of an H100 (228 KB of
    shared memory, 1 KB of it reserved a block, and 2048 threads)."""
    src = open(os.path.join(os.path.dirname(lp.__file__), "csrc",
                            "lznt1_parse.cu")).read()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    assert const["U"] == U and const["MIN_MATCH"] == lp.MIN_MATCH
    assert const["STAGE"] == STAGE and const["STAGE_BYTES"] == SLICE + 8
    assert "constexpr int SENT = 1 << 28;" in src and SENT == 1 << 28
    assert "constexpr int COPY_BIT = 1 << 20;" in src and COPY_BIT == 1 << 20
    assert "constexpr int EMPTY_VAL = COPY_BIT | 0x3FFF;" in src
    assert "constexpr int THREADS = 32 * WARPS;" in src
    blocks = const["BLOCKS_PER_SM"]
    stage = const["WARPS"] * const["STAGE_BYTES"]
    assert blocks * (stage + 1024) <= 228 * 1024
    assert blocks * 32 * const["WARPS"] <= 2048
    # the furthest byte an active token reads: the hi byte of token 4095
    # after 4095 literals, behind 512 flag bytes; a window's first group
    # lies at most one byte past it, and the window reads 4 groups of at
    # most 17 bytes and a token of the fifth past that
    assert 4095 + 512 + 1 < STAGE
    assert 4095 + 512 + 2 + 4 * 17 + 16 < SLICE

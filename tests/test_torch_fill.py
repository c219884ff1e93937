"""The record fill of ``csrc/fill_records.cu`` as a numpy model, against
the plain fills ``fill.fill_records_delta2_ref`` /
``fill.fill_records_delta_ref`` and tpucomp's ``fill_records_delta2`` /
``fill_records_delta`` (XLA) and ``fill_pallas.fill_records_delta2_fused``
(interpret mode).

The kernel cuts a row's R record slots into tiles (``fill.tiles``), one
block a tile.  :func:`fill_model` does what it does: when a row has more
than one tile, a first pass gives each tile's least real position and
distinct count (:func:`summary`); block t then zeroes its share of the
bytes before the row's first record, and, unless no record of its tile
has a span, writes the spans of its tile: record i owns [p_i, e_i), e_i
the least real position in a later slot or the tile's carry.  The model
counts the writes of every byte, and every byte must be written once.
Its tile width is a parameter, so that rows of a few hundred slots cross
many tile edges; the rows of :data:`CASES` put runs of equal positions,
empty slots and out-of-range positions on those edges.  tpucomp's fills
take rows in which no empty slot splits a run of one position
(:func:`unsplit`).  The card tests in ``tests/test_torch_cuda.py``
import :data:`CASES`, :func:`case_rows` and :func:`edges_of` by module
name, so JAX and tpucomp are imported inside the tests that use them.
Every value is an integer: the tolerance is exact equality.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

from tpucomp_torch.codecs import lznt1 as lz
from tpucomp_torch.codecs import xpress as xp
from tpucomp_torch.codecs import xpress_huff as xh
from tpucomp_torch.kernels import fill, lznt1_parse, xh_parse, xp_parse

SENT = 1 << 28  # common.SENT_KEY, the parses' empty slot
VEC = 4  # ints a vector store of the kernel
V_MASK = fill.V_RING - 1
P_MASK = fill.P_RING - 1
# (tile_slots, per): narrow tiles with many edges, and the kernel's own
GEOMETRIES = ((32, 4), (96, 16), (fill.TILE_SLOTS, fill.PER_THREAD))
CASES = ("run_at_edge", "empty_at_edge", "empty_tile", "empty_tail",
         "one_span", "no_record", "out_of_range", "keep", "all_literals",
         "random", "decreasing")
# tpucomp's contract: real positions do not decrease
TPU_CASES = CASES[:-1]
KEEP_DISTINCT = 40  # the distinct records of each "keep" row


def summary(pos, U, T, TS):
    """The first pass for one row: each tile's least real position (U if
    none) and its count of real slots that end their run of adjacent
    equal positions."""
    R = len(pos)
    real = (pos >= 0) & (pos < U)
    nxt = np.append(pos[1:], -1)
    ends = real & (nxt != pos)
    mins, cnts = [], []
    for t in range(T):
        a, b = t * TS, min(t * TS + TS, R)
        mins.append(int(pos[a:b][real[a:b]].min()) if real[a:b].any() else U)
        cnts.append(int(ends[a:b].sum()))
    return mins, cnts


def fill_model(pos, val, U, keep=None, tile_slots=fill.TILE_SLOTS,
               per=fill.PER_THREAD):
    """(val [N, U], pos [N, U], ovf [N]) as the kernel computes them, and
    the writes of each byte [N, U]."""
    pos, val = np.asarray(pos, np.int64), np.asarray(val, np.int64)
    N, R = pos.shape
    keep = min(R, U) if keep is None else keep
    T, TS, threads = fill.tiles(R, tile_slots, per)
    assert threads * per >= TS and TS % per == 0 and (T - 1) * TS < max(R, 1)
    vo = np.full((N, U), -1, np.int64)
    po = np.full((N, U), -1, np.int64)
    ovf = np.zeros(N, np.int32)
    writes = np.zeros((N, U), np.int64)

    def put(n, a, b, v, p):
        vo[n, a:b], po[n, a:b] = v, p
        writes[n, a:b] += 1

    for n in range(N):
        mins, cnts = summary(pos[n], U, T, TS)
        row_min = min(mins)
        ovf[n] = sum(cnts) > keep
        for t in range(T):
            carry = min(mins[t + 1:], default=U)
            if T > 1:  # block t zeroes its share of [0, row_min)
                share = -(-(-(-U // T)) // VEC) * VEC
                z0 = min(t * share, U)
                put(n, z0, max(z0, min(z0 + share, row_min)), 0, 0)
                if mins[t] >= carry:
                    continue  # no span starts in this tile
            a, b = t * TS, min(t * TS + TS, R)
            p, v = pos[n, a:b], val[n, a:b]
            real = (p >= 0) & (p < U)
            if len(p):  # a thread loads its values only if one is real
                v = np.where(np.repeat(np.add.reduceat(
                    real, np.arange(0, len(p), per)) > 0, per)[:len(p)], v, 0)
            # e_i: the least real position in a later slot, or the carry
            suffix = np.minimum.accumulate(np.where(real, p, U)[::-1])[::-1]
            after = np.minimum(np.append(suffix[1:], U), carry)
            vis = real & (p < after)
            if T == 1:
                put(n, 0, int(suffix[0]) if len(p) else U, 0, 0)
            S, W = p[vis], v[vis] & V_MASK
            if not len(S):
                continue
            # the tile's range [S[0], carry) in vectors of VEC bytes, each
            # byte's record found by a search of the starts
            lo, hi = int(S[0]), carry
            for q in range(lo // VEC, -(-hi // VEC)):
                j = np.arange(q * VEC, q * VEC + VEC)
                j = j[(j >= lo) & (j < hi)]
                r = np.searchsorted(S, j, side="right") - 1
                assert (r >= 0).all()
                vo[n, j], po[n, j] = W[r], S[r] & P_MASK
                writes[n, j] += 1
    return vo.astype(np.int32), po.astype(np.int32), ovf, writes


def _monotone(R, U, rng, n_real):
    """A row of R slots with n_real non-decreasing real positions in [0,
    U) (some repeated) and empty slots (SENT or -1) between them."""
    slots = np.sort(rng.choice(R, size=min(n_real, R), replace=False))
    pos = np.full(R, SENT, np.int64)
    pos[rng.random(R) < 0.5] = -1
    pos[slots] = np.sort(rng.integers(0, U, len(slots)))
    return pos


def case_rows(name, R, U, edges, rng):
    """[rows, R] int32 positions and values for case ``name``, with its
    features on the tile edges ``edges`` (slot indices; one in the row's
    middle stands in when there are none)."""
    edges = [e for e in edges if 0 < e < R] or [R // 2]
    rows = []
    if name == "run_at_edge":
        # runs of equal positions across, ending at and starting at edges
        for lo, hi in ((-3, 3), (-4, 0), (0, 4), (-1, 1)):
            pos = _monotone(R, U, rng, R)
            for e in edges:
                a, b = max(0, e + lo), min(R, e + hi)
                pos[a:b] = pos[a]
            rows.append(pos)
    elif name == "empty_at_edge":
        for same in (True, False):
            pos = _monotone(R, U, rng, R)
            for e in edges:
                a, b = max(3, e - 2), min(R - 1, e + 2)
                pos[a:b] = [SENT, -1, SENT, -1][:b - a]
                if same:  # one position on both sides of the gap
                    pos[b] = pos[a - 1]
            rows.append(pos)
    elif name == "empty_tile":
        pos = _monotone(R, U, rng, R)
        a = edges[0]
        b = edges[1] if len(edges) > 1 else min(R, a + max(1, R // 8))
        pos[a:b] = SENT
        rows.append(pos)
        pos = _monotone(R, U, rng, R)
        pos[edges[0]:] = -1  # every tile past the first empty
        rows.append(pos)
    elif name == "empty_tail":
        # XH's layout: a dense prefix, then empty slots to the row's end
        for n in (R // 5, min(R, U - 3), 1):
            pos = np.full(R, SENT, np.int64)
            pos[:n] = np.sort(rng.choice(np.arange(3, U), n, replace=False))
            rows.append(pos)
    elif name == "one_span":
        pos = np.full(R, SENT, np.int64)
        pos[R // 2] = 0  # one record, the whole row
        rows.append(pos)
        pos = np.full(R, -1, np.int64)
        pos[:2] = (0, 1)  # the zeros unit: a literal, then one match
        rows.append(pos)
        pos = np.full(R, SENT, np.int64)
        pos[-1] = U - 1  # zeros to the last byte
        rows.append(pos)
    elif name == "no_record":
        rows += [np.full(R, SENT, np.int64), np.full(R, -1, np.int64),
                 np.where(rng.random(R) < 0.5, SENT, -1)]
    elif name == "out_of_range":
        for _ in range(2):
            pos = _monotone(R, U, rng, R)
            bad = rng.random(R) < 0.3
            pos[bad] = rng.choice([-5, -1, U, U + 7, SENT, 1 << 30, -(1 << 31),
                                   (1 << 31) - 1], bad.sum())
            for e in edges:
                pos[e] = U  # an out-of-range slot on every edge
            rows.append(pos)
    elif name == "keep":
        # KEEP_DISTINCT distinct positions, each a run of 1-3 adjacent
        # slots, with at least two empty slots between runs
        for _ in range(2):
            p = np.sort(rng.choice(U, KEEP_DISTINCT, replace=False))
            reps = rng.integers(1, 4, KEEP_DISTINCT)
            start = np.sort(rng.choice(R - 5 * KEEP_DISTINCT, KEEP_DISTINCT,
                                       replace=False)) \
                + 5 * np.arange(KEEP_DISTINCT)
            pos = np.full(R, SENT, np.int64)
            for a, q, k in zip(start, p, reps):
                pos[a:a + k] = q
            rows.append(pos)
    elif name == "all_literals":
        pos = np.full(R, SENT, np.int64)
        pos[:min(R, U)] = np.arange(min(R, U))
        rows.append(pos)
    elif name == "random":
        for _ in range(3):
            pos = np.sort(rng.integers(-3, U + 40, R))
            pos[rng.random(R) < 0.2] = SENT
            rows.append(pos)
    elif name == "decreasing":
        # a malformed stream's records: a stretch that steps back, across
        # an edge (not tpucomp's contract; the plain fill defines it)
        for back in (5, U // 3):
            pos = np.sort(rng.integers(0, U, R))
            for e in edges:
                pos[e:] = np.maximum(pos[e:] - back, 0)
            rows.append(pos)
    else:
        raise ValueError(name)
    pos = np.stack(rows).astype(np.int32)
    val = rng.integers(0, 1 << 24, pos.shape).astype(np.int32)
    val[:, ::7] |= -(1 << 31)  # bits past the 22-bit ring
    return pos, val


def edges_of(R, tile_slots, per):
    T, TS, _ = fill.tiles(R, tile_slots, per)
    return [t * TS for t in range(1, T)]


def _ref(pos, val, U, keep=None):
    got = fill.fill_records_delta2_ref(torch.from_numpy(pos),
                                       torch.from_numpy(val), U, keep)
    return [g.numpy() for g in got]


def _check_model(pos, val, U, keep, tile_slots, per):
    """The model against both plain fills, every byte written once.
    Returns the model's (val, pos, ovf)."""
    vo, po, ovf, writes = fill_model(pos, val, U, keep, tile_slots, per)
    assert (writes == 1).all(), "a byte written other than once"
    want = _ref(pos, val, U, keep)
    np.testing.assert_array_equal(vo, want[0])
    np.testing.assert_array_equal(po, want[1])
    np.testing.assert_array_equal(ovf, want[2])
    np.testing.assert_array_equal(vo, fill.fill_records_delta_ref(
        torch.from_numpy(pos), torch.from_numpy(val), U).numpy())
    return vo, po, ovf


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("R,U", [(300, 512), (700, 512), (1000, 1030)])
def test_model_matches_plain_on_edge_rows(R, U, geometry):
    """Every case at R below and above U, at a width that is no multiple
    of 4, with narrow tiles (many edges) and the kernel's own."""
    rng = np.random.default_rng(R * 7 + U + geometry[0])
    edges = edges_of(R, *geometry)
    for name in CASES:
        pos, val = case_rows(name, R, U, edges, rng)
        _check_model(pos, val, U, None, *geometry)
        if name == "keep":
            for keep, want in ((KEEP_DISTINCT, 0), (KEEP_DISTINCT - 1, 1)):
                _, _, ovf = _check_model(pos, val, U, keep, *geometry)
                assert (ovf == want).all()


def test_cases_hit_their_edges():
    """The edge rows do what they are for at the narrow geometry: runs and
    empty slots on tile edges, a tile with no real record, zero spans."""
    R, U, (ts, per) = 700, 512, GEOMETRIES[0]
    T, TS, _ = fill.tiles(R, ts, per)
    rng = np.random.default_rng(3)
    edges = edges_of(R, ts, per)
    assert len(edges) == T - 1 >= 10
    pos, _ = case_rows("run_at_edge", R, U, edges, rng)
    e = edges[0]
    assert (pos[0, e - 3:e + 3] == pos[0, e - 3]).all()
    pos, _ = case_rows("empty_tile", R, U, edges, rng)
    mins, _ = summary(pos[0], U, T, TS)
    assert mins[1] == U and mins[2] < U
    pos, _ = case_rows("empty_at_edge", R, U, edges, rng)
    assert pos[0, e] in (SENT, -1) and pos[0, e - 3] == pos[0, e + 2]


def unsplit(pos, U):
    """tpucomp's contract also wants no empty slot between two real
    records at one position (its compaction would put both at one
    target): empty the earlier of each such pair, until none is left."""
    pos = pos.copy()
    for row in pos:
        while True:
            idx = np.flatnonzero((row >= 0) & (row < U))
            split = (row[idx[:-1]] == row[idx[1:]]) & (np.diff(idx) > 1)
            if not split.any():
                break
            row[idx[:-1][split]] = SENT
    return pos


@functools.lru_cache(maxsize=None)
def _tpu_batch(R, U):
    """The edge rows of :data:`TPU_CASES` at the narrow geometry, stacked
    into one batch (one XLA compile a shape), through :func:`unsplit`."""
    rng = np.random.default_rng(R + U)
    edges = edges_of(R, *GEOMETRIES[0])
    parts = [case_rows(name, R, U, edges, rng) for name in TPU_CASES]
    kpos, kval = case_rows("keep", R, U, edges, rng)
    return (unsplit(np.concatenate([p for p, _ in parts]), U),
            np.concatenate([v for _, v in parts]), (kpos, kval))


def _tpu_delta2(pos, val, U, keep=None, fused=False):
    import jax.numpy as jnp
    from tpucomp.kernels import common as t_common
    from tpucomp.kernels import fill_pallas

    if fused:
        out = fill_pallas.fill_records_delta2_fused(
            jnp.asarray(pos), jnp.asarray(val), U,
            min(pos.shape[1], U) if keep is None else keep, interpret=True)
    else:
        out = t_common.fill_records_delta2(jnp.asarray(pos), jnp.asarray(val),
                                           U, keep=keep)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("R,U", [(448, 512), (700, 512)])
def test_model_matches_tpucomp_on_edge_rows(R, U):
    """The edge rows through tpucomp's XLA fills (both forms) and, where R
    <= U, its fused Pallas fill in interpret mode.  The "keep" rows at keep
    = their distinct count and one below: ovf compares everywhere, bytes
    on the rows that do not overflow (tpucomp's XLA form drops the
    records past keep)."""
    import jax.numpy as jnp
    from tpucomp.kernels import common as t_common

    pos, val, (kpos, kval) = _tpu_batch(R, U)
    ts, per = GEOMETRIES[0]
    vo, po, ovf, writes = fill_model(pos, val, U, None, ts, per)
    assert (writes == 1).all()
    wants = [_tpu_delta2(pos, val, U)]
    if R <= U:
        wants.append(_tpu_delta2(pos, val, U, fused=True))
    for want in wants:
        for g, w in zip((vo, po, ovf), want):
            np.testing.assert_array_equal(g, w)
    vf, _ = t_common.fill_records_delta(jnp.asarray(pos), jnp.asarray(val), U)
    np.testing.assert_array_equal(vo, np.asarray(vf))
    for keep in (KEEP_DISTINCT, KEEP_DISTINCT - 1):
        got = fill_model(kpos, kval, U, keep, ts, per)
        want = _tpu_delta2(kpos, kval, U, keep)
        np.testing.assert_array_equal(got[2], want[2])
        assert (want[2] == (keep < KEEP_DISTINCT)).all()
        ok = want[2] == 0
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g[ok], w[ok])


@functools.lru_cache(maxsize=None)
def _units(n, size):
    """n seeded units of ``size`` bytes: text-like, a periodic run, random
    bytes and zeros in turn."""
    rng = np.random.default_rng(size)
    words = [b"the ", b"fill ", b"of ", b"records ", b"spans ", b"tile "]
    out = []
    for k in range(n):
        if k % 4 == 0:
            s = b"".join(words[i] for i in rng.integers(0, len(words), size))
        elif k % 4 == 1:
            s = (b"abcabd" * size)[:size // 2] + bytes(
                rng.integers(0, 256, size, dtype=np.uint8))
        elif k % 4 == 2:
            s = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        else:
            s = bytes(size)
        out.append(s[:size])
    return out


def _hold_parsed(rec_pos, rec_val, U, value_only=False):
    """Parsed records: the model (kernel and narrow geometries) against
    the plain fills and tpucomp's XLA fills; tpucomp's fused fill where
    R <= U and U % 128 == 0."""
    import jax.numpy as jnp
    from tpucomp.kernels import common as t_common

    pos, val = rec_pos.numpy(), rec_val.numpy()
    for geometry in GEOMETRIES[1:]:
        vo, po, ovf = _check_model(pos, val, U, None, *geometry)
    if value_only:
        want, _ = t_common.fill_records_delta(jnp.asarray(pos),
                                              jnp.asarray(val), U)
        np.testing.assert_array_equal(vo, np.asarray(want))
        return
    wants = [_tpu_delta2(pos, val, U)]
    if pos.shape[1] <= U and U % 128 == 0:
        wants.append(_tpu_delta2(pos, val, U, fused=True))
    for want in wants:
        for g, w in zip((vo, po, ovf), want):
            np.testing.assert_array_equal(g, w)


def test_lznt1_parsed_records():
    """LZNT1 chunks by the native encoder, parsed by the port's plain
    parse: the value-only fill ([N, 4616] records, U = 4096)."""
    from tpucomp import _native

    data = b"".join(_units(4, lz.CHUNK))
    payloads, comps = lz.split_stream(_native.lznt1_compress(data))
    batch = lz.pack_chunks(payloads, comps, "cpu")
    rec_pos, rec_val, _, err = lznt1_parse.lznt1_parse_ref(*batch)
    assert not err.any() and rec_pos.shape[1] > lz.CHUNK
    _hold_parsed(rec_pos, rec_val, lz.CHUNK, value_only=True)


def test_xh_parsed_records():
    """Xpress Huffman units by the native encoder, parsed by the port's
    plain parse: a dense prefix of records, then empty slots (R = U)."""
    from tpucomp import _native

    U = 2048
    units = _units(4, U)
    streams = [_native.xh_compress(u) for u in units]
    batch = xh.pack_units(streams, [len(u) for u in units], U, "cpu")
    rec_pos, rec_val, _, err = xh_parse.xh_parse_ref(
        *xh.parse_inputs(*batch), U)
    assert not err.any() and rec_pos.shape[1] == U
    _hold_parsed(rec_pos, rec_val, U)


def test_xpress_parsed_records():
    """Plain Xpress units by the native encoder, parsed by the port's
    plain parse: records at payload slots, empty slots between (R > U for
    the random unit)."""
    from tpucomp import _native

    U = 1024
    units = _units(4, U)
    streams = [_native.xpress_compress(u) for u in units]
    batch = xp.pack_units(streams, [len(u) for u in units], U, "cpu")
    rec_pos, rec_val, _, err = xp_parse.xp_parse_ref(*batch, U)
    assert not err.any() and rec_pos.shape[1] > U
    _hold_parsed(rec_pos, rec_val, U)


def test_wrappers_dispatch_by_device():
    """CPU tensors take the plain versions; another device raises."""
    rng = np.random.default_rng(5)
    pos, val = case_rows("random", 300, 512, [], rng)
    args = (torch.from_numpy(pos), torch.from_numpy(val), 512)
    for got, want in ((fill.fill_records_delta2(*args),
                       fill.fill_records_delta2_ref(*args)),
                      ((fill.fill_records_delta(*args),),
                       (fill.fill_records_delta_ref(*args),))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    meta = torch.empty((2, 8), dtype=torch.int32, device="meta")
    for fn in (fill.fill_records_delta2, fill.fill_records_delta):
        with pytest.raises(ValueError):
            fn(meta, meta, 16)


def test_kernel_constants():
    """The wrapper's geometry is the kernel's."""
    src = open(os.path.join(os.path.dirname(fill.__file__), "csrc",
                            "fill_records.cu")).read()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    assert consts["K"] == fill.PER_THREAD
    assert consts["THREADS"] == fill.THREADS
    assert consts["VEC"] == VEC
    assert fill.tiles(4616) == (1, 4624, 320)  # LZNT1's records
    assert fill.tiles(65536) == (8, 8192, 512)  # XH's
    assert fill.tiles(73712) == (9, 8192, 512)  # plain Xpress's
    assert fill.tiles(0) == (1, 16, 32)

"""The full-row far level of ``csrc/far_row.cu`` as a numpy model, against
the plain level ``gather.far_row_ref`` and tpucomp's
``_far_level_segmented(out, U, U)`` with its zeroing (Pallas pair gather
in interpret mode).

The kernel gives a block a row.  :func:`far_row_model` does what it
does: :func:`sweepable` classifies each row; a swept row's chunks of 1024
resolve from left to right (:func:`sweep`: a tag whose source lies in an
earlier chunk takes that chunk's output, tags inside the chunk resolve
by pointer doubling, at most ``CHUNK_ROUNDS`` rounds, what is left live
is on a cycle and becomes 0); any other row runs the level's synchronous
rounds (:func:`round_loop`).  The cases of :data:`CASES` are also what
the card tests in ``tests/test_torch_cuda.py`` run through the kernel
(they import :func:`case_rows` and :func:`far_row_model` by module
name).  Every value is an integer: the tolerance is exact equality.
"""

import os
import re

import numpy as np
import pytest
import torch

from tpucomp_torch.kernels import common, gather

FAR_TAG = common.FAR_TAG
CHUNK = 1024
CHUNK_ROUNDS = (CHUNK - 1).bit_length() + 1
# whole chunks (131072: the one-shot XH decode's [history | block] row);
# a partial last one; U % 4
WIDTHS = (131072, 65536, 65024, 4610)


def states(x):
    """The level's state of each position (int64): a byte, or
    ``(1 << 17) | src``."""
    x = np.asarray(x, np.int64)
    return np.where(x & FAR_TAG, (1 << 17) | (x & (FAR_TAG - 1)), x & 0x1FF)


def live(s, U):
    return ((s >> 17) == 1) & ((s & 0x1FFFF) < U)


def chunk_end(U):
    """[U]: the end of the chunk that holds each position."""
    return np.minimum((np.arange(U) // CHUNK + 1) * CHUNK, U)


def sweepable(x):
    """[N] bool: the rows the kernel sweeps.  A row is not swept when a
    live tag points at or past its chunk's end, or a tag has state bits
    above 17 (it keeps its own low 9 bits, but a chaser adopts its low 17
    bits as a pointer)."""
    U = x.shape[1]
    s = states(x)
    wide = ((np.asarray(x) & FAR_TAG) != 0) & ((s >> 17) != 1)
    past = live(s, U) & ((s & 0x1FFFF) >= chunk_end(U))
    return ~(wide | past).any(axis=1)


def round_loop(x, cap=None):
    """The level's synchronous rounds, then the zeroing: every round, each
    live state takes its source's state, masked to 18 bits."""
    U = x.shape[1]
    cap = cap or common.level_cap(U)
    s = states(x)
    for _ in range(cap):
        lv = live(s, U)
        if not lv.any():
            break
        s = np.where(lv, np.take_along_axis(
            s, np.where(lv, s & 0x1FFFF, 0), 1) & 0x3FFFF, s)
    return np.where((s >> 17) == 1, 0, s & 0x1FF)


def sweep(x):
    """The sweep of rows that are all sweepable: (out [N, U], rounds [N,
    chunks], the doubling rounds each chunk of each row ran)."""
    N, U = x.shape
    out = np.zeros((N, U), np.int64)
    nchunks = -(-U // CHUNK)
    rounds = np.zeros((N, nchunks), int)
    for k in range(nchunks):
        base, end = k * CHUNK, min(U, (k + 1) * CHUNK)
        s = states(x[:, base:end])
        src = s & 0x1FFFF
        early = live(s, U) & (src < base)
        assert not (live(s, U) & (src >= end)).any()
        s = np.where(early, np.take_along_axis(out, np.where(early, src, 0),
                                               1), s)
        for _ in range(CHUNK_ROUNDS):
            lv = live(s, U)
            if not lv.any():
                break
            rounds[:, k] += lv.any(axis=1)  # the block's OR
            s = np.where(lv, np.take_along_axis(
                s, np.where(lv, (s & 0x1FFFF) - base, 0), 1) & 0x3FFFF, s)
        out[:, base:end] = np.where((s >> 17) == 1, 0, s & 0x1FF)
    return out, rounds


def far_row_model(x):
    """The kernel on int32 [N, U]: (out int32 [N, U], looped bool [N], the
    rows that ran the round loop)."""
    x = np.asarray(x)
    swept = sweepable(x)
    out = np.zeros(x.shape, np.int64)
    if swept.any():
        out[swept] = sweep(x[swept])[0]
    if (~swept).any():
        out[~swept] = round_loop(x[~swept])
    return out.astype(np.int32), ~swept


# ---- the cases: (rows int32 [N, U], looped bool [N]) -----------------------


def _bytes(r, n, U):
    """Untagged values: bits 9-23 set too (the state keeps the low 9)."""
    return r.integers(0, FAR_TAG, (n, U))


def _no_tags(r, U):
    return _bytes(r, 2, U), [False, False]


def _run_d1(r, U):
    """A byte, then a tag to the position before across the whole row:
    one 1023-hop chain inside each chunk."""
    x = _bytes(r, 1, U)
    x[0, 1:] = FAR_TAG | np.arange(U - 1)
    return x, [False]


def _cross_chunks(r, U):
    """Row 0: one chain through every chunk, each hop a chunk and one
    back; row 1:
    sources up to three chunks back, a third of the positions bytes."""
    x = _bytes(r, 2, U)
    j = np.arange(U)
    x[0, CHUNK + 1:] = FAR_TAG | (j[CHUNK + 1:] - CHUNK - 1)
    back = np.maximum(j - r.integers(1, 3 * CHUNK, U), 0)
    x[1] = np.where(r.random(U) < 0.3, x[1], FAR_TAG | back)
    return x, [False, False]


def _dead(r, U):
    """Dead tags (sources at or past U, to 0x1FFFF) and the positions that
    chase them; position 0 a tag to itself (a source clamped to 0), and
    tags to it; a source with bit 17 set (live, to 5).  At U = 2^17 no
    source of 17 bits lies past the row: the dead tags are FAR_TAG | U,
    whose state is a tag to position 0."""
    x = _bytes(r, 2, U)
    j = np.arange(U)
    dead = r.random((2, U)) < 0.05
    x[dead] = FAR_TAG | r.integers(U, max(U + 1, 0x20000), dead.sum())
    chase = r.random((2, U)) < 0.4
    x[chase] = FAR_TAG | np.maximum(
        np.broadcast_to(j, (2, U))[chase] - r.integers(1, 9000, chase.sum()),
        0)
    x[:, 0] = FAR_TAG
    x[0, 1:40] = FAR_TAG  # into the self-loop
    x[1, 3] = FAR_TAG | U  # just past the row
    x[1, 8] = FAR_TAG | (1 << 17) | 5
    x[1, 9:20] = FAR_TAG | 8
    return x, [False, False]


def _wide(r, U):
    """Tags with state bits above 17 (its own low 9 bits stay; a chaser
    adopts its low 17 bits), chased from later positions: the round
    loop."""
    x = _bytes(r, 2, U)
    x[0, 9] = FAR_TAG | (1 << 20) | 77
    x[0, 10:30] = FAR_TAG | 9
    x[0, 77] = 65
    x[1, U - 2] = FAR_TAG | (3 << 18) | 0x1FFFF  # to a dead source
    x[1, U - 1] = FAR_TAG | (U - 2)
    return x, [True, True]


def _forward_in_chunk(r, U):
    """Row 0: every tag points ahead inside its own chunk, the chunk's
    last position a byte; row 1: random sources inside the chunk, both
    ways (cycles among them)."""
    x = _bytes(r, 2, U)
    j = np.arange(U)
    end = chunk_end(U)
    fwd = np.minimum(j + r.integers(1, 300, U), end - 1)
    x[0] = np.where((j < end - 1) & (r.random(U) < 0.7), FAR_TAG | fwd, x[0])
    inside = (j // CHUNK) * CHUNK + (r.random(U) * (end - j // CHUNK * CHUNK)
                                     ).astype(np.int64)
    x[1] = np.where(r.random(U) < 0.5, FAR_TAG | inside, x[1])
    return x, [False, False]


def _later_chunk(r, U):
    """Backward rows with one tag each at the chunk boundary: to the first
    position of the next chunk (the round loop), deep in a later chunk
    (the round loop), to the last position of its own chunk (swept)."""
    x = _bytes(r, 3, U)
    j = np.arange(U)
    back = np.maximum(j - r.integers(1, 9000, U), 0)
    x[:] = np.where(r.random((3, U)) < 0.5, FAR_TAG | back, x)
    x[0, 100] = FAR_TAG | CHUNK
    x[1, 7] = FAR_TAG | (U - 1)
    x[2, CHUNK + 7] = FAR_TAG | (min(2 * CHUNK, U) - 1)
    return x, [True, True, False]


def _cycles(r, U):
    """Row 0: a 2-cycle, a 3-cycle and a self-loop inside chunks, chased
    from later chunks (swept, all 0); row 1: a cycle across two chunks
    (the round loop)."""
    x = _bytes(r, 2, U)
    x[0, 100], x[0, 200] = FAR_TAG | 200, FAR_TAG | 100
    x[0, 300:303] = FAR_TAG | np.array([301, 302, 300])
    x[0, CHUNK + 5] = FAR_TAG | (CHUNK + 5)
    x[0, CHUNK + 6: CHUNK + 60] = FAR_TAG | 301
    x[0, U - 50:] = FAR_TAG | (CHUNK + 5)
    x[1, 100], x[1, CHUNK + 100] = FAR_TAG | (CHUNK + 100), FAR_TAG | 100
    x[1, U - 1] = FAR_TAG | 100
    return x, [False, True]


def _mixed(r, U):
    """As the card tests' far states: half the positions tags to anywhere
    in the row or in its first chunk (the round loop)."""
    x = _bytes(r, 2, U)
    tag = r.random((2, U)) < 0.5
    src = np.where(r.random((2, U)) < 0.5, r.integers(0, CHUNK, (2, U)),
                   r.integers(0, U, (2, U)))
    x[tag] = FAR_TAG | src[tag]
    return x, [True, True]


CASES = {
    "no_tags": _no_tags, "run_d1": _run_d1, "cross_chunks": _cross_chunks,
    "dead": _dead, "wide": _wide, "forward_in_chunk": _forward_in_chunk,
    "later_chunk": _later_chunk, "cycles": _cycles, "mixed": _mixed,
}


NARROW = (1, 7, 1000, CHUNK, CHUNK + 1)  # a chunk or less; just past one


def narrow_rows(U, seed=0):
    """Rows of width U in ``NARROW``: (rows int32 [3, U], looped bool [3]).
    Row 0: backward tags and a tag to itself at position 0 (swept); row
    1: sources anywhere, position 0 to the last position (swept while
    the row is one chunk, else the round loop); row 2: a tag with state
    bits above 17 (the round loop)."""
    r = np.random.default_rng([seed, U])
    x = _bytes(r, 3, U)
    j = np.arange(U)
    x[0] = np.where(r.random(U) < 0.6,
                    FAR_TAG | np.maximum(j - r.integers(1, 50, U), 0), x[0])
    x[0, 0] = FAR_TAG
    x[1] = np.where(r.random(U) < 0.5, FAR_TAG | r.integers(0, U, U), x[1])
    x[1, 0] = FAR_TAG | (U - 1)
    x[2, U // 2] = FAR_TAG | (1 << 19) | 3
    return x.astype(np.int32), np.array([False, U > CHUNK, True])


def case_rows(name, U, seed=0):
    """Case ``name`` at width U: (rows int32 [N, U], looped bool [N], the
    branch each row takes)."""
    r = np.random.default_rng([seed, list(CASES).index(name), U])
    x, looped = CASES[name](r, U)
    return np.asarray(x, np.int64).astype(np.int32), np.array(looped)


@pytest.mark.parametrize("U", WIDTHS)
@pytest.mark.parametrize("name", list(CASES))
def test_model_matches_plain(name, U):
    x, looped = case_rows(name, U)
    got, got_looped = far_row_model(x)
    np.testing.assert_array_equal(got_looped, looped)
    np.testing.assert_array_equal(
        got, gather.far_row_ref(torch.from_numpy(x)).numpy())
    # the round loop is the level itself, on every row
    np.testing.assert_array_equal(round_loop(x), got)


@pytest.mark.parametrize("U", NARROW)
def test_model_on_narrow_rows(U):
    x, looped = narrow_rows(U)
    got, got_looped = far_row_model(x)
    np.testing.assert_array_equal(got_looped, looped)
    np.testing.assert_array_equal(
        got, gather.far_row_ref(torch.from_numpy(x)).numpy())


# one row of each case for tpucomp's level in interpret mode (its cost
# grows with rows times rounds)
TPUCOMP_ROWS = {"no_tags": 0, "run_d1": 0, "cross_chunks": 1, "dead": 0,
                "wide": 0, "forward_in_chunk": 1, "later_chunk": 2,
                "cycles": 0, "mixed": 0}


def test_model_matches_tpucomp(monkeypatch):
    """A row of every case at U = 16384 against tpucomp's full-row level
    and zeroing, its pair gather in interpret mode."""
    import jax.numpy as jnp
    from tpucomp.kernels import common as t_common

    monkeypatch.setenv("TPUCOMP_GATHER_PALLAS", "interpret")
    U = 16384
    rows = [case_rows(name, U) for name in TPUCOMP_ROWS]
    x = np.stack([r[0][k] for r, k in zip(rows, TPUCOMP_ROWS.values())])
    seg = np.asarray(t_common._far_level_segmented(
        jnp.asarray(x), U, U, interpret=True))
    got, looped = far_row_model(x)
    np.testing.assert_array_equal(got, np.where((seg & FAR_TAG) != 0, 0,
                                                seg))
    np.testing.assert_array_equal(looped, [r[1][k] for r, k in zip(
        rows, TPUCOMP_ROWS.values())])


def test_model_on_decoded_states():
    """The XH decode's post-near-walk states of ``test_torch_xh_kernels``
    (its full-row level test holds ``far_row_ref`` to tpucomp's on them):
    the four decoded rows are swept, the four seeded ones point forward
    and run the round loop."""
    from test_torch_xh_kernels import _far_inputs

    x = _far_inputs()
    got, looped = far_row_model(x)
    np.testing.assert_array_equal(
        got, gather.far_row_ref(torch.from_numpy(x)).numpy())
    assert looped.tolist() == [False] * 4 + [True] * 4


def test_chunk_rounds():
    """Doubling rounds inside a chunk: 10 for a 1023-hop chain (the run of
    displacement 1), the cap for a chunk with a cycle, none for rows
    whose tags all point to earlier chunks."""
    U = 65536
    _, rounds = sweep(case_rows("run_d1", U)[0])
    assert (rounds == 10).all() and CHUNK_ROUNDS == 11
    _, rounds = sweep(case_rows("cycles", U)[0][:1])
    assert (rounds[0, :2] == CHUNK_ROUNDS).all() and rounds[0, 2:].max() == 0
    assert sweep(case_rows("no_tags", U)[0])[1].max() == 0
    # hops of more than a chunk back: nothing to double
    assert sweep(case_rows("cross_chunks", U)[0][:1])[1].max() == 0


def test_kernel_constants():
    """The kernel's chunk, round cap and tag are the model's, and
    BLOCKS_PER_SM blocks of two chunk buffers and THREADS threads fit an
    SM of an H100 (228 KB of shared memory, 1 KB of it reserved a block,
    2048 threads): at least the 546 rows of a [546, 65536] batch on 132
    SMs at once."""
    src = open(os.path.join(os.path.dirname(gather.__file__), "csrc",
                            "far_row.cu")).read()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    assert const["CHUNK"] == CHUNK and const["CHUNK_ROUNDS"] == CHUNK_ROUNDS
    assert "constexpr int FAR_TAG = 1 << 24;" in src and FAR_TAG == 1 << 24
    assert "__shared__ alignas(16) int32_t buf[NBUF][CHUNK];" in src
    blocks, threads = const["BLOCKS_PER_SM"], const["THREADS"]
    assert blocks * (const["NBUF"] * 4 * CHUNK + 1024) <= 228 * 1024
    assert blocks * threads <= 2048 and blocks * 132 >= 546
    assert CHUNK % (4 * threads) == 0

"""The near walk of ``csrc/resolve_near.cu`` as a numpy model, against
the plain walk ``resolve.resolve_near_ref`` and tpucomp's Pallas
``resolve_copies`` (interpret mode, ``_far_rounds`` patched out).

The kernel gives a warp a 512-byte segment and codes a near copy as a
pointer, ``~source``.  :func:`doubling` resolves as the kernel does:
rounds in which every pointer takes what its source holds, all reads
before any write, while any position of the segment holds a pointer, and
counts each segment's rounds.  The adversarial segments of
:data:`CASES` are also what the card tests in ``tests/test_torch_cuda.py``
run through the kernel (they import :func:`case_inputs` by module name).
Every value is an integer: the tolerance is exact equality.
"""

import functools
import os
import re
from unittest import mock

import numpy as np
import pytest
import torch

from tpucomp_torch.kernels import common, resolve

SEG = resolve.SEG
FAR_TAG = common.FAR_TAG
# U: rows (8 to 256 segments); 131072 is the one-shot XH decode's
# [history | block] row
WIDTHS = {512: 8, 4096: 2, 65536: 1, 131072: 1}


def codes(is_copy, disp, litv):
    """Planes [N, U] -> [N * U / 512, 512]: each segment position's code,
    its value (>= 0) or ~source."""
    N, U = is_copy.shape
    is_copy, disp, litv = (x.reshape(-1, SEG).astype(np.int64)
                           for x in (is_copy, disp, litv))
    j = np.arange(SEG)
    d = np.minimum(disp, 0x1FFFF)
    base = ((np.arange(len(d)) % (U // SEG)) * SEG)[:, None]
    near = (d >= 1) & (d <= j)
    far = FAR_TAG | np.maximum(base + j - d, 0)
    return np.where(is_copy != 0, np.where(near, ~(j - d), far),
                    litv & 0x1FF)


def doubling(is_copy, disp, litv):
    """The kernel's resolve on [N, U] planes: (out int32 [N, U], rounds
    int [N * U / 512], each segment's rounds)."""
    N, U = is_copy.shape
    win = codes(is_copy, disp, litv)
    rounds = np.zeros(win.shape[0], int)
    while True:
        live = (win < 0).any(axis=1)  # __any_sync
        if not live.any():
            break
        rounds += live
        win = np.where(win < 0, np.take_along_axis(
            win, np.where(win < 0, ~win, 0), 1), win)
    return win.reshape(N, U).astype(np.int32), rounds


def depth(is_copy, disp, litv):
    """[S]: the most hops any position of each segment takes, through its
    near copies, to a position that holds no pointer; one position of the
    segment at a time."""
    code = codes(is_copy, disp, litv)
    hops = np.zeros(code.shape, int)
    for j in range(SEG):  # a source comes before its reader
        hops[:, j] = np.where(code[:, j] < 0, np.take_along_axis(
            hops, np.where(code[:, j:j + 1] < 0, ~code[:, j:j + 1], 0),
            1)[:, 0] + 1, 0)
    return hops.max(axis=1)


def log2_rounds(hops):
    """Pointer doubling's rounds for a chain of ``hops`` hops."""
    return np.ceil(np.log2(hops + 1)).astype(int)


# ---- the adversarial segments ---------------------------------------------


def _run_d1(r, S):
    """A literal, then 511 copies of displacement 1: a 511-hop chain."""
    is_copy = np.ones((S, SEG), bool)
    is_copy[:, 0] = False
    return is_copy, np.ones((S, SEG), np.int64), r.integers(0, 1 << 12, (S, SEG))


def _d_eq_j(r, S):
    """Copies whose source is position 0 (d == j), among literals."""
    j = np.arange(SEG)
    is_copy = r.random((S, SEG)) < 0.8
    is_copy[:, 0] = False
    return is_copy, np.broadcast_to(j, (S, SEG)), r.integers(0, 512, (S, SEG))


def _d0_or_past_start(r, S):
    """Copies of displacement 0 or reaching before the segment (d > j)."""
    j = np.arange(SEG)
    disp = np.where(r.random((S, SEG)) < 0.5, 0,
                    j + r.integers(1, 5000, (S, SEG)))
    return r.random((S, SEG)) < 0.9, disp, r.integers(0, 512, (S, SEG))


def _far_chain(r, S):
    """A far tag carried through in-segment chains: position 0 reaches
    before the segment; every other position copies from within it
    (half the segments a run of displacement 1, half random sources)."""
    j = np.arange(SEG)
    disp = np.where(np.arange(S)[:, None] % 2 == 0, 1,
                    1 + (r.random((S, SEG)) * j).astype(np.int64))
    disp[:, 0] = r.integers(1, 300, S)
    return np.ones((S, SEG), bool), disp, r.integers(0, 512, (S, SEG))


def _clamped(r, S):
    """Displacements >= 0x20000 (clamped to 0x1FFFF: far), some a few
    past it (masked, they would be near), among near copies."""
    big = r.choice(np.array([0x1FFFF, 0x20000, 0x30000, 0x7FFFFFFF]),
                   (S, SEG))
    big = np.where(r.random((S, SEG)) < 0.5, big,
                   0x20000 + r.integers(1, 64, (S, SEG)))
    disp = np.where(r.random((S, SEG)) < 0.5, big,
                    r.integers(1, 8, (S, SEG)))
    return r.random((S, SEG)) < 0.8, disp, r.integers(0, 512, (S, SEG))


def _all_literal(r, S):
    """No copy; disp holds any value, litv values past 9 bits."""
    return (np.zeros((S, SEG), bool), r.integers(-1 << 31, 1 << 31, (S, SEG)),
            r.integers(0, 1 << 31, (S, SEG)))


def _all_far(r, S):
    """Every position a copy reaching before the segment."""
    j = np.arange(SEG)
    return (np.ones((S, SEG), bool), j + r.integers(1, 70000, (S, SEG)),
            r.integers(0, 512, (S, SEG)))


def _period(r, S):
    """XH's fold (``codecs/xpress_huff.near_inputs``): in a match of
    displacement d, byte k < d copies d back, byte k >= d copies from the
    match's first period (disp = k - k mod d)."""
    is_copy = np.zeros(S * SEG, bool)
    disp = np.zeros(S * SEG, np.int64)
    p = 0
    while p < S * SEG:
        p += int(r.integers(0, 4))  # literals
        d = int(r.choice([1, 2, 3, 7, 16, 31, 33, 100, 600]))
        k = np.arange(min(int(r.integers(3, 400)), S * SEG - p))
        is_copy[p:p + len(k)] = True
        disp[p:p + len(k)] = np.where(k < d, d, k - k % d)
        p += len(k)
    return (is_copy.reshape(S, SEG), disp.reshape(S, SEG),
            r.integers(0, 512, (S, SEG)))


def _mixed(r, S):
    """Literals, short and long copies, as the far levels meet them."""
    disp = np.where(r.random((S, SEG)) < 0.7, r.integers(0, 40, (S, SEG)),
                    r.integers(1, 5000, (S, SEG)))
    return r.random((S, SEG)) < 0.6, disp, r.integers(0, 512, (S, SEG))


CASES = {
    "run_d1": _run_d1, "d_eq_j": _d_eq_j, "d0_or_past_start":
    _d0_or_past_start, "far_chain": _far_chain, "clamped": _clamped,
    "all_literal": _all_literal, "all_far": _all_far, "period": _period,
    "mixed": _mixed,
}


def case_inputs(name, N, U, seed=0):
    """Case ``name`` as numpy planes [N, U]: (is_copy bool, disp int32,
    litv int32)."""
    r = np.random.default_rng([seed, list(CASES).index(name), U])
    is_copy, disp, litv = CASES[name](r, N * U // SEG)
    return (np.ascontiguousarray(is_copy).reshape(N, U),
            np.asarray(disp, np.int64).astype(np.int32).reshape(N, U),
            np.asarray(litv, np.int64).astype(np.int32).reshape(N, U))


def _pallas(is_copy, disp, litv):
    """tpucomp's Pallas walk in interpret mode, up to its far rounds."""
    import jax.numpy as jnp
    from tpucomp.kernels import resolve_pallas

    with mock.patch.object(resolve_pallas, "_far_rounds",
                           lambda out, *a, **k: out):
        return np.asarray(resolve_pallas.resolve_copies(
            jnp.asarray(is_copy), jnp.asarray(disp), jnp.asarray(litv),
            interpret=True))


@functools.lru_cache(maxsize=None)
def _plain(U):
    """The plain walk's output on every case's rows at width U, stacked."""
    planes = [np.concatenate(p) for p in zip(
        *(case_inputs(name, WIDTHS[U], U) for name in CASES))]
    return resolve.resolve_near_ref(
        *(torch.from_numpy(p) for p in planes)).numpy()


@pytest.mark.parametrize("U", list(WIDTHS))
@pytest.mark.parametrize("name", list(CASES))
def test_model_matches_plain_and_pallas(name, U):
    planes = case_inputs(name, WIDTHS[U], U)
    got, rounds = doubling(*planes)
    k = list(CASES).index(name)
    np.testing.assert_array_equal(
        got, _plain(U)[k * WIDTHS[U]:(k + 1) * WIDTHS[U]])
    np.testing.assert_array_equal(got, _pallas(*planes))
    # each round halves every chain: log2 of the longest chain's hops
    np.testing.assert_array_equal(rounds, log2_rounds(depth(*planes)))
    assert rounds.max() <= 9


def test_rounds_of_the_edge_cases():
    """A run of displacement 1 takes 9 rounds; sources at position 0 one
    round; literals and far copies none."""
    U = 4096
    rounds = {n: doubling(*case_inputs(n, 1, U))[1] for n in CASES}
    assert (rounds["run_d1"] == 9).all()
    assert (rounds["d_eq_j"] == 1).all()
    for n in ("all_literal", "all_far", "d0_or_past_start"):
        assert (rounds[n] == 0).all()


def test_kernel_constants():
    """The kernel's segment and tag are the wrapper's SEG and FAR_TAG, and
    BLOCKS_PER_SM blocks of WARPS segments' stages fit an SM of an H100
    (228 KB of shared memory, 1 KB of it reserved a block, and 2048
    threads)."""
    src = open(os.path.join(os.path.dirname(resolve.__file__), "csrc",
                            "resolve_near.cu")).read()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    assert const["SEG"] == SEG
    assert "constexpr int FAR_TAG = 1 << 24;" in src and FAR_TAG == 1 << 24
    assert "constexpr int THREADS = 32 * WARPS;" in src
    assert "static_assert(sizeof(Stage) == STAGE_BYTES" in src
    stage = const["STAGE_BYTES"]
    assert stage == 2 * 4 * SEG + SEG  # disp, litv, is_copy
    blocks = const["BLOCKS_PER_SM"]
    assert blocks * (const["WARPS"] * stage + 1024) <= 228 * 1024
    assert blocks * 32 * const["WARPS"] <= 2048

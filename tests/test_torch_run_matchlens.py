"""The run matcher's CUDA decomposition (``tpucomp_torch/kernels/csrc/
run_matchlens.cu``) as a numpy model, on the CPU.

The model takes the kernel's own steps: rows cut into tiles of PER
positions x WARP lanes x WARPS warps; each thread's break mask of its PER
positions; each position's next break in the thread's segment by the
mask's lowest set bit; the first later lane with a break by a ballot; the
warps' first breaks, then the carry: the least of the later tiles' first
breaks, which the launch's first kernel finds by scanning each tile from
its start, a warp's positions a step, or U.  With narrow tiles (4 x 4 x 2
= 32 positions) short rows cross many tile edges.  The model is held to
the plain version (``runs.run_matchlens_ref``, which the wrapper runs on
CPU tensors) and to tpucomp's Pallas run matcher in interpret mode
(``runs_pallas.run_matchlens_fused``, rows of a multiple of 128) and its
XLA form (``common.run_matchlens``), exactly: every value is an integer.
The card tests (``tests/test_torch_cuda.py``) import ``CASES`` and
``case_rows`` by module name, so JAX and tpucomp are imported only in the
test that runs them.
"""

import os
import re

import numpy as np
import pytest
import torch

from tpucomp_torch.kernels import runs

PER, WARP, WARPS = 16, 32, 8  # the kernel's: positions a thread, lanes, warps
NARROW = (4, 4, 2)  # 32-position tiles
NONE = np.iinfo(np.int32).max
DISPS = (1, 2, 3, 7, 255)  # the encoders' (1, 2, 3), and two wider ones

# edge rows, each built for a tile width tw (see case_rows)
CASES = ("run_one_edge", "run_many_edges", "zeros", "steps_at_firsts",
         "steps_at_lasts", "tile_without_break", "random", "text_like",
         "short_chunk")


def case_rows(name, U, tw, seed=0):
    """Rows [2, U] of the edge case ``name`` for tiles of ``tw`` positions
    (two seeds' worth of random bytes around each pattern)."""
    r = np.random.default_rng([seed, U, tw, CASES.index(name)])
    x = r.integers(0, 256, (2, U)).astype(np.uint8)
    p = np.arange(U)
    if name == "run_one_edge":  # a run across the first tile edge
        x[:, max(tw - 10, 0):tw + 10] = 9
    elif name == "run_many_edges":  # a run across several edges
        x[:, tw // 2:3 * tw + 5] = 4
    elif name == "zeros":  # one run a row: every edge crossed
        x[:] = 0
    elif name == "steps_at_firsts":  # a break at each tile's first position
        x[:] = (p // tw + 1) % 256
    elif name == "steps_at_lasts":  # ... and at each tile's last
        x[:] = ((p + 1) // tw + 1) % 256
    elif name == "tile_without_break":  # tile 1 with no break for d <= 3
        x[:, tw - 3:2 * tw] = 6
    elif name == "text_like":  # slowly varying: short runs everywhere
        x[:] = r.integers(0, 3, (2, U))
    elif name == "short_chunk":  # a short chunk, then zero padding
        x[:, 37:] = 0
    return x


def ffs(v):
    """numpy ``__ffs``: the 1-based index of the lowest set bit, 0 for 0."""
    v = np.asarray(v, np.int64)
    low = v & -v
    return np.where(low != 0, np.log2(np.maximum(low, 1)).astype(np.int64)
                    + 1, 0)


def break_masks(x, d, p0, per):
    """Each thread's mask: bit k set where q = p0 + k is a break (q < d,
    q >= U or x[q] != x[q - d]).  Returns int64 [N, threads]."""
    N, U = x.shape
    q = p0[:, None] + np.arange(per)  # [threads, per]
    inside = q < U
    cur = np.where(inside, x[:, np.minimum(q, U - 1)], 0)
    back = q - d
    prev = np.where((back >= 0) & inside, x[:, np.clip(back, 0, U - 1)], 0)
    brk = (q < d) | ~inside | (cur != prev)
    return (brk.astype(np.int64) << np.arange(per)).sum(-1)


def matchlens_model(x, disps, per=PER, warp=WARP, warps=WARPS):
    """The kernel's lengths for each d of ``disps``: int32 [N, U] each."""
    N, U = x.shape
    tile = per * warp * warps
    T = -(-U // tile)
    p0 = np.arange(T * warp * warps) * per  # each thread's first position
    lane = np.arange(warp)
    later_bits = ((1 << warp) - 1) & ~((2 << lane) - 1)  # lanes after each
    outs = []
    for d in disps:
        brk = break_masks(x, d, p0, per)  # [N, threads]
        fb = np.where(brk != 0, p0 + ffs(brk) - 1, NONE)
        # the first kernel: a warp scans each tile from its start, a step
        # of `warp` threads' positions at a time, to the first step whose
        # ballot has a lane with a break; that lane's first break.  The
        # carry of tile t is the least of tiles t + 1 .. T - 1, or U
        steps = fb.reshape(N, T, -1, warp)
        hit = (steps != NONE).any(-1)  # [N, T, steps]
        at = np.take_along_axis(steps, hit.argmax(-1)[..., None, None],
                                2)[..., 0, :]
        first = np.where(hit.any(-1), at.min(-1), NONE)
        carry = np.full((N, T), U, np.int64)
        for t in range(T - 2, -1, -1):
            carry[:, t] = np.minimum(carry[:, t + 1], first[:, t + 1])
        # a warp's ballot of the lanes with a break
        bw, fw = brk.reshape(N, T, warps, warp), fb.reshape(N, T, warps, warp)
        bal = ((bw != 0).astype(np.int64) << lane).sum(-1)  # [N, T, warps]
        later = bal[..., None] & later_bits
        L = np.maximum(ffs(later) - 1, 0)
        right = np.where(later != 0, np.take_along_axis(fw, L, -1), NONE)
        wfirst = np.where(bal != 0, np.take_along_axis(
            fw, np.maximum(ffs(bal) - 1, 0)[..., None], -1)[..., 0], NONE)
        # the first later warp with a break, else the carry
        after = np.empty_like(wfirst)
        nxt = carry
        for w in range(warps - 1, -1, -1):
            after[..., w] = nxt
            nxt = np.where(wfirst[..., w] != NONE, wfirst[..., w], nxt)
        right = np.where(right != NONE, right, after[..., None])
        right = right.reshape(N, -1)
        # each position's next break: in its own mask, else `right`
        k = np.arange(per)
        nb = brk[..., None] >> k
        q = p0[:, None] + k
        nxt_q = np.where(nb != 0, q + ffs(nb) - 1, right[..., None])
        outs.append((nxt_q - q).reshape(N, -1)[:, :U].astype(np.int32))
    return outs


def stage_slot(lane, c):
    """The kernel's stage index (16-byte chunks) of chunk ``c`` of lane
    ``lane``'s 16 lengths."""
    return lane * 4 + (c ^ ((lane >> 1) & 3))


def test_constants_match_the_kernel():
    src = open(os.path.join(os.path.dirname(runs.__file__), "csrc",
                            "run_matchlens.cu")).read()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    assert (const["THREADS"], const["PER"]) == (WARP * WARPS, PER)
    assert runs.TILE == PER * WARP * WARPS == 4096
    assert const["MAXD"] == runs.DISPS_PER_LAUNCH == 4
    assert "lane * 4 + (c ^ ((lane >> 1) & 3))" in src  # stage_slot


def test_stage_is_conflict_free_and_covers_the_warp_once():
    """Writes (lane l, chunk c) and reads (instruction j, lane l: output
    chunk g = 32 j + l, of lane g // 4) go through the same swizzle; each
    quarter warp (8 lanes of 16 bytes) hits 8 different 16-byte bank
    groups, and each instruction stores 512 contiguous bytes."""
    slots = {stage_slot(lane, c) for lane in range(WARP) for c in range(4)}
    assert slots == set(range(4 * WARP))
    for c in range(4):  # writes
        for q in range(4):
            groups = {stage_slot(lane, c) % 8 for lane in range(8 * q,
                                                                8 * q + 8)}
            assert len(groups) == 8
    seen = []
    for j in range(4):  # reads and stores
        g = j * 32 + np.arange(WARP)
        for q in range(4):
            gg = g[8 * q:8 * q + 8]
            assert len({stage_slot(x // 4, x % 4) % 8 for x in gg}) == 8
        pos = 4 * g  # first position of each lane's 16-byte store
        assert (np.diff(pos) == 4).all() and pos[0] == 128 * j
        seen += [p + i for p in pos for i in range(4)]
    assert sorted(seen) == list(range(PER * WARP))


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("U,tiles", [(512, NARROW), (1000, NARROW),
                                     (4096, (PER, WARP, WARPS)),
                                     (5000, (PER, WARP, WARPS))])
def test_model_matches_plain(name, U, tiles):
    per, warp, warps = tiles
    x = case_rows(name, U, per * warp * warps)
    disps = DISPS + (U, U + 5)  # two launches; d >= U: no run anywhere
    want = runs.run_matchlens(torch.from_numpy(x), disps)
    got = matchlens_model(x, disps, per, warp, warps)
    for d, g, w in zip(disps, got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=f"d = {d}")
    if name == "zeros":  # one run a row from d on
        assert got[0][0, 1] == U - 1 and got[-1].max() == 0


def test_model_matches_tpucomp():
    """The edge rows for narrow and for the kernel's tiles in one batch of
    4096-byte rows, against tpucomp's fused Pallas kernel in interpret
    mode and its XLA scan; the model with either tile width."""
    import jax.numpy as jnp

    from tpucomp.kernels import common as t_common
    from tpucomp.kernels import runs_pallas

    U = 4096
    x = np.concatenate([case_rows(n, U, tw) for tw in (32, 4096)
                        for n in CASES])
    xj = jnp.asarray(x, jnp.int32)
    want_k = runs_pallas.run_matchlens_fused(xj, DISPS, interpret=True)
    want_x = t_common.run_matchlens(xj, DISPS)
    for tiles in (NARROW, (PER, WARP, WARPS)):
        got = matchlens_model(x, DISPS, *tiles)
        for d, g, wk, wx in zip(DISPS, got, want_k, want_x):
            np.testing.assert_array_equal(g, np.asarray(wk),
                                          err_msg=f"d = {d}, {tiles}")
            np.testing.assert_array_equal(g, np.asarray(wx),
                                          err_msg=f"d = {d}, {tiles}")

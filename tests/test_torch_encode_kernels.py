"""tpucomp_torch's LZ encode kernels and match finder, in their plain
PyTorch versions on the CPU, against tpucomp's: the run matcher, the row
sort, the greedy commit walk (with and without the layout sums), the hash
match finder and extend_saturated.

tpucomp's Pallas kernels run in interpret mode, as its own tests run
them, and its XLA forms with no Pallas mode set.  The same seeded inputs,
made with numpy, go through both packages.  Every value is an integer,
so the tolerance is exact equality.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from conftest import make_corpus
from test_torch_commit import walk_rows
from tpucomp.kernels import common as t_common
from tpucomp.kernels import lz_pallas, runs_pallas, sort_pallas
from tpucomp_torch.kernels import commit, match, runs, sort


@pytest.fixture(autouse=True)
def _xla_mode(monkeypatch):
    # tpucomp's common.* take their XLA forms unless a Pallas mode is set
    for var in ("TPUCOMP_PALLAS", "TPUCOMP_RUNS_PALLAS",
                "TPUCOMP_SORT_PALLAS", "TPUCOMP_COMMIT_PALLAS"):
        monkeypatch.delenv(var, raising=False)


def _rows(U, seed=0):
    """Eight rows of U bytes: zeros, periods 1-3 (with breaks), corpus
    text, random bytes, and a short chunk followed by zero padding."""
    r = np.random.default_rng(seed)
    text = np.frombuffer(make_corpus(random.Random(seed), U), np.uint8)
    rows = np.zeros((8, U), np.uint8)
    rows[1] = 7
    rows[1, U // 3] = 8  # a break inside the run
    rows[2] = np.tile([1, 2], U // 2)
    rows[3] = np.tile([5, 6, 7], U // 3 + 1)[:U]
    rows[3, 100:110] = 0
    rows[4] = text
    rows[5] = r.integers(0, 256, U)
    rows[6, :37] = text[:37]  # a short chunk: runs reach into the padding
    rows[7, : U // 2] = np.tile([9, 9, 4], U)[: U // 2]
    return rows


@pytest.mark.parametrize("U", [512, 4096])
def test_run_matchlens_matches_tpucomp(U):
    x = _rows(U, seed=U)
    disps = (1, 2, 3)
    got = [t.numpy() for t in runs.run_matchlens(torch.from_numpy(x), disps)]
    want_k = runs_pallas.run_matchlens_fused(jnp.asarray(x, jnp.int32), disps,
                                             interpret=True)
    want_x = t_common.run_matchlens(jnp.asarray(x, jnp.int32), disps)
    for g, wk, wx in zip(got, want_k, want_x):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(wk))
        np.testing.assert_array_equal(g, np.asarray(wx))
    assert got[0][0, 0] == 0 and got[0][0, 1] == U - 1  # zeros: one run


def test_run_matchlens_odd_displacements():
    """A displacement past the row, one wider than the last, and more
    displacements than one launch takes."""
    x = _rows(256, seed=3)
    disps = (1, 4, 255, 300, 2)
    got = runs.run_matchlens(torch.from_numpy(x), disps)
    for d, g in zip(disps, got):
        want = np.zeros_like(x, np.int32)
        for p in range(x.shape[1] - 1, d - 1, -1):
            same = x[:, p] == x[:, p - d]
            want[:, p] = np.where(same, 1 + (want[:, p + 1]
                                             if p + 1 < x.shape[1] else 0), 0)
        np.testing.assert_array_equal(g.numpy(), want)


def _sort_planes(P, U, kind, seed):
    r = np.random.default_rng(seed)
    N = 8
    if kind == "permutation":
        key = np.stack([r.permutation(U) for _ in range(N)])
    else:  # random unique keys, negative ones among them
        key = np.stack([r.choice(np.arange(-(1 << 30), 1 << 30, 4099), U,
                                 replace=False) for _ in range(N)])
    planes = [key.astype(np.int32)] + [
        r.integers(-(1 << 31), 1 << 31, (N, U)).astype(np.int32)
        for _ in range(P - 1)]
    return planes


@pytest.mark.parametrize("P", [1, 2, 9])
@pytest.mark.parametrize("U", [256, 4096])
@pytest.mark.parametrize("kind", ["permutation", "random"])
def test_sort_rows_matches_tpucomp(P, U, kind):
    planes = _sort_planes(P, U, kind, seed=P * U)
    got = sort.sort_rows([torch.from_numpy(p) for p in planes])
    want_k = sort_pallas.bitonic_sort_rows(
        [jnp.asarray(p) for p in planes], interpret=True)
    want_x = lax.sort([jnp.asarray(p) for p in planes], dimension=1,
                      num_keys=1)
    assert len(got) == P
    for g, wk, wx in zip(got, want_k, want_x):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(g.numpy(), np.asarray(wx))


def _walk_inputs(N, n, seed):
    r = np.random.default_rng(seed)
    is_match = r.random((N, n)) < 0.35
    best_len = r.integers(3, 60, (N, n)).astype(np.int32)
    best_len[0] = 1  # matches of length 1 act as literals
    okpos = np.ones((N, n), bool)
    okpos[1, n // 2:] = False  # a short chunk
    okpos[2] = False  # an empty one
    is_match[3] = False  # all literals
    return is_match, best_len, okpos


def _numpy_walk(is_match, best_len, okpos):
    N, n = is_match.shape
    com = np.zeros((N, n), bool)
    ta = np.zeros((N, n), np.int32)
    db = np.zeros((N, n), np.int32)
    for i in range(N):
        nc = t = d = 0
        for p in range(n):
            db[i, p] = d
            if p == nc and okpos[i, p]:
                com[i, p] = True
                t += 1
                d += 2 if is_match[i, p] else 1
                nc = p + (best_len[i, p] if is_match[i, p] else 1)
            ta[i, p] = t
    return com, ta, db


def _hold_walk_to_tpucomp(ins):
    tins = [torch.from_numpy(np.ascontiguousarray(a)) for a in ins]
    jins = [jnp.asarray(a) for a in ins]
    got = commit.greedy_commit(*tins).numpy()
    assert got.dtype == bool
    np.testing.assert_array_equal(
        got, np.asarray(lz_pallas.greedy_commit(*jins, interpret=True)))
    np.testing.assert_array_equal(
        got, np.asarray(t_common.greedy_commit(*jins, mode=None)))

    com, ta, db = (t.numpy() for t in commit.greedy_commit_layout(*tins))
    want = lz_pallas.greedy_commit_layout(*jins, interpret=True)
    for g, w in zip((com, ta, db), want):
        np.testing.assert_array_equal(g, np.asarray(w))
    # the XLA commit+layout scan of tpucomp's encoder, written out
    for g, w in zip((com, ta, db), _numpy_walk(*ins)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(com, got)


@pytest.mark.parametrize("n", [512, 1000])
def test_greedy_commit_matches_tpucomp(n):
    _hold_walk_to_tpucomp(_walk_inputs(9, n, seed=n))


@pytest.mark.parametrize("n", [129, 1000])
def test_greedy_commit_edge_rows_match_tpucomp(n):
    """Long jumps (to n and past it), a constant jump, a row whose
    segment chains never meet, zero lengths with is_match set, okpos holes
    mid-row, an all-false okpos row; lengths below tpucomp's 2^20."""
    _, *ins = walk_rows(n, seed=n + 1)
    assert 0 <= ins[1].min() and ins[1].max() < 1 << 20
    _hold_walk_to_tpucomp(ins)


def _match_rows(n, seed):
    """Text, long and short repeats, random bytes, zeros: every candidate
    count, saturated lengths and ties."""
    rng = random.Random(seed)
    text = make_corpus(rng, 4 * n)
    rows = [text[:n], (text[:300] * (n // 300 + 1))[:n],
            bytes(rng.randrange(256) for _ in range(n)), bytes(n),
            (b"abcdefgh" * n)[:n], text[n:2 * n]]
    return np.stack([np.frombuffer(r, np.uint8) for r in rows])


@pytest.mark.parametrize("seed,max_disp", [(3, None), (5, None), (3, 700),
                                           (5, 300)])
def test_hash_best_match_matches_tpucomp(seed, max_disp):
    n = 4096 if seed == 3 and max_disp is None else 1024
    x = _match_rows(n, seed=n + seed)
    kw = dict(hash_bits=13, num_cands=3, cap=32, max_disp=max_disp, seed=seed)
    got = match.hash_best_match(torch.from_numpy(x), n, **kw)
    want = t_common.hash_best_match(jnp.asarray(x, jnp.int32), n, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] == 32).any() and (got[0] > 0).any()

    ext = match.extend_saturated(*got, 32, n)
    want_ext = t_common.extend_saturated(*want, 32, n)
    np.testing.assert_array_equal(ext.numpy(), np.asarray(want_ext))
    assert (ext > 64).any()  # saturated matches did extend


@pytest.mark.parametrize("num_cands,cap,hash_bits", [(1, 16, 11), (0, 16, 13),
                                                     (4, 8, 15)])
def test_hash_best_match_other_configs(num_cands, cap, hash_bits):
    n = 512
    x = _match_rows(n, seed=7)
    kw = dict(hash_bits=hash_bits, num_cands=num_cands, cap=cap)
    got = match.hash_best_match(torch.from_numpy(x), n, **kw)
    want = t_common.hash_best_match(jnp.asarray(x, jnp.int32), n, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sorted_words_equal_tpucomps_nine_plane_sort():
    """tpucomp sorts the key with eight rolls of the word plane; the port
    sorts the key alone and gathers the words: the planes are equal."""
    n = 4096
    x = _match_rows(n, seed=11)
    xj = jnp.asarray(x, jnp.int32)
    w = t_common.le_words(xj)
    shifted = tuple(jnp.roll(w, -4 * t, axis=1) for t in range(8))
    key = match.hash_keys(torch.from_numpy(x), 13, 12)
    srt = t_common.sort_rows((jnp.asarray(key.numpy()), *shifted))
    (skey,) = sort.sort_rows((key,))
    np.testing.assert_array_equal(skey.numpy(), np.asarray(srt[0]))
    tw = match.le_words(torch.from_numpy(x))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(w))
    sw = match.sorted_words(tw, skey & (n - 1), 8)
    for g, want in zip(sw, srt[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="uint8"):
        runs.run_matchlens(x, (1,))
    with pytest.raises(ValueError, match="positive"):
        runs.run_matchlens(x.to(torch.uint8), (0,))
    with pytest.raises(ValueError, match="int32"):
        sort.sort_rows((x, x.to(torch.int64)))
    with pytest.raises(ValueError, match="bool"):
        commit.greedy_commit(x, x, x.bool())
    with pytest.raises(ValueError, match="seed"):
        match.hash_best_match(x.to(torch.uint8), 64, seed=4)

"""The archive probe's CUDA form (``tpucomp_torch/kernels/csrc/
far_probe.cu``) as a numpy model, on the CPU: one pass, each tag
following at most ``rounds`` hops through the INPUT plane, each position
written once by one (block, thread, slot) of the kernel's grid.

The model is held exactly to the plain version (``gather.far_probe_ref``:
tpucomp's synchronous rounds, which the wrapper runs on CPU tensors) for
0, 1, 2 and 5 rounds, and to tpucomp's probe loop
(``common._far_rounds(fast=True)`` with its levels skipped, the
pair-packed Pallas gather ``probe_gather_pairs`` in interpret mode, its
round budget set to the same count), as ``tests/test_torch_xh_kernels.py``
holds the plain version; that loop zeroes the tags left, so the model's
are zeroed there too.  The card tests (``tests/test_torch_cuda.py``)
import ``CASES`` and ``case_rows`` by module name, so JAX and tpucomp are
imported only in the tests that run them.
"""

import os
import re

import numpy as np
import pytest
import torch

from tpucomp_torch.kernels import common, gather

FAR_TAG = common.FAR_TAG
THREADS, PER = 256, 4  # the kernel's: threads a block, positions a thread
ROUNDS = (0, 1, 2, 5)
CASES = ("chains", "past_the_row", "bit17", "no_tag", "cycles", "mixed")


def case_rows(name, U, seed=0):
    """Rows [3, U] of states in the near walk's encoding (bytes, or
    ``FAR_TAG | src``) for the edge case ``name``."""
    r = np.random.default_rng([seed, U, CASES.index(name)])
    x = r.integers(0, 256, (3, U)).astype(np.int32)
    if name == "chains":  # chains of 0 to 6 tags, at random positions
        for row in x:
            spots = r.permutation(U)
            k = 0
            while k + 7 <= U // 2:
                n = int(r.integers(0, 7))
                at = spots[k:k + n + 1]  # at[0] stays a byte
                row[at[1:]] = FAR_TAG | at[:-1]
                k += n + 1
    elif name == "past_the_row":  # sources at and past U, and chains to them
        x[:, 3] = FAR_TAG | U
        x[:, 4] = FAR_TAG | (U + 1)
        x[:, 5] = FAR_TAG | (FAR_TAG - 1)
        x[:, 6] = FAR_TAG | 5
        x[:, 7] = FAR_TAG | 6
        x[:, 8] = -1  # every bit: a tag whose source is past the row
    elif name == "bit17":  # sources with bit 17 set (past any row here)
        x[:, 10:20] = FAR_TAG | (1 << 17) | np.arange(10)
        x[:, 20:30] = FAR_TAG | np.arange(10, 20)
    elif name == "cycles":  # never resolve; chains into them neither
        x[:, 100], x[:, 200] = FAR_TAG | 200, FAR_TAG | 100
        x[:, 300] = FAR_TAG | 300
        x[:, 301] = FAR_TAG | 300
    elif name == "mixed":  # half tags, sources anywhere; values past 8 bits
        tag = r.random((3, U)) < 0.5
        src = r.integers(0, U + 64, (3, U))
        x[tag] = FAR_TAG | src[tag]
        x[0, ~tag[0]] |= 0x1200  # not a tag: its byte is its low 8 bits
    return x


def probe_model(x, rounds, threads=THREADS, per=PER):
    """The kernel: block b of a row takes positions [b T, (b + 1) T), T =
    threads * per, thread t its ``per`` from b T + t per; each tag follows
    its chain through ``x`` at most ``rounds`` hops.  Returns int32 [N, U]
    and asserts that each position is written once."""
    N, U = x.shape
    tile = threads * per
    b, t, k = np.meshgrid(np.arange(-(-U // tile)), np.arange(threads),
                          np.arange(per), indexing="ij")
    p = (b * tile + t * per + k).ravel()
    p = p[p < U]  # the positions the grid's threads write, in their order
    assert (np.bincount(p, minlength=U) == 1).all()
    rows = np.arange(N)[:, None]
    v = x[:, p]
    cur = v.copy()
    live = (v & FAR_TAG) != 0
    for _ in range(rounds):
        if not live.any():
            break
        src = cur & (FAR_TAG - 1)
        ok = src < U
        fetched = np.where(live & ok, x[rows, np.where(ok, src, 0)], 0)
        byte = live & ((fetched & FAR_TAG) == 0)  # a byte, or 0 past the row
        v = np.where(byte, fetched & 0xFF, v)
        cur = np.where(live & ~byte, fetched, cur)
        live &= ~byte
    out = np.empty_like(x)
    out[:, p] = v
    return out


def tpucomp_probes(x, rounds, monkeypatch):
    """tpucomp's probe loop alone on ``x``, at most ``rounds`` rounds:
    ``_far_rounds(fast=True)`` with the levels skipped (``min_hop`` past
    U, the full-row level the identity), then its zeroing of the tags
    left (as ``test_torch_xh_kernels.test_probe_rounds_match_tpucomp``)."""
    import jax.numpy as jnp

    from tpucomp.kernels import common as t_common

    monkeypatch.setenv("TPUCOMP_GATHER_PALLAS", "interpret")
    monkeypatch.setattr(t_common, "_far_level_segmented",
                        lambda out, *a, **k: out)
    monkeypatch.setattr(t_common, "ARCHIVE_PROBE_BUDGET", rounds)
    U = x.shape[1]
    return np.asarray(t_common._far_rounds(jnp.asarray(x), U, U, fast=True,
                                           interpret=True))


def test_constants_match_the_kernel():
    from tpucomp.kernels import common as t_common

    src = open(os.path.join(os.path.dirname(gather.__file__), "csrc",
                            "far_probe.cu")).read()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    assert (const["THREADS"], const["PER"]) == (THREADS, PER)
    assert "constexpr int FAR_TAG = 1 << 24;" in src and FAR_TAG == 1 << 24
    assert common.ARCHIVE_PROBE_BUDGET == t_common.ARCHIVE_PROBE_BUDGET == 2


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("U", [512, 1000, 4096])
def test_model_matches_plain(name, U):
    x = case_rows(name, U)
    for rounds in ROUNDS:
        got = probe_model(x, rounds, *((THREADS, PER) if U == 4096
                                       else (8, PER)))
        want = gather.far_probe(torch.from_numpy(x), rounds).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"rounds {rounds}")
    if name == "no_tag":
        np.testing.assert_array_equal(got, x)
    if name == "chains":  # six hops end every chain, five leave some
        assert (got & FAR_TAG).any()
        assert not (probe_model(x, 6) & FAR_TAG).any()


@pytest.mark.parametrize("rounds", ROUNDS)
def test_model_matches_tpucomp(rounds, monkeypatch):
    """Every edge row in one batch of 1024-byte rows."""
    x = np.concatenate([case_rows(n, 1024) for n in CASES])
    got = probe_model(x, rounds)
    want = tpucomp_probes(x, rounds, monkeypatch)
    np.testing.assert_array_equal(np.where((got & FAR_TAG) != 0, 0, got),
                                  want)
    if rounds:
        assert (got != x).any()

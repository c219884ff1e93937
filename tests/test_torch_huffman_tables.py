"""The Huffman table kernel (``tpucomp_torch/kernels/csrc/
huffman_tables.cu``) as a serial numpy model, on the CPU: the counting
rank of the keys ``(freq, sym)``, the two-queue merge that records each
consumed node's parent step and each step's leaves, the reverse pass over
the nodes that gives their depths (in place of the plain version's
pointer jumping), the Kraft repair on the leaves a depth, the lengths
handed out longest first, and the canonical codes from the counts of
32-symbol segments.

The model is held exactly, row by row, to the plain version the wrapper
runs on CPU tensors (``huffman.huffman_tables_ref``: ``huffman_code_
lengths``, then the codes of ``canonical_from_lengths``) and to tpucomp's
``huffman_code_lengths`` (XLA).  A row's counts must sum below 2^30,
the cost of an empty queue slot; the kernel, and the model, give a row
at or above it lengths and codes of -1.  The card tests (``tests/test_torch_
cuda.py``) import ``CASES`` and ``case_rows`` by module name, so JAX and
tpucomp are imported only in the test that runs them.
"""

import numpy as np
import pytest
import torch

from tpucomp_torch.kernels import huffman
from test_torch_trace import _fib_freqs

S = huffman.NUM_SYMBOLS
MAX_LEN = huffman.MAX_CODE_LEN
EMPTY = 1 << 30  # the kernel's cost of an empty queue slot
SEG = 32  # symbols of a warp-wide segment


def model(freqs, empty=EMPTY):
    """One row of int counts -> (lengths, codes, leaf depths), the
    kernel's steps in order, with ``empty`` the cost of an empty slot.
    ``leaf depths`` holds each used symbol's depth in the merge tree
    before the repair (0 elsewhere)."""
    f = np.asarray(freqs, np.int64)
    sym = np.arange(S)
    used = f > 0
    n = int(used.sum())
    if int(f[used].sum()) >= empty:  # outside the merge's domain
        none = np.full(S, -1, np.int32)
        return none, none, np.zeros(S, np.int64)
    # 1. each used symbol counts the keys below its own: unique keys, so
    # its rank is its place in (freq, sym) order
    key = np.where(used, f, 1 << 31)
    below = (key[None, :] < key[:, None]) | (
        (key[None, :] == key[:, None]) & (sym[None, :] < sym[:, None]))
    rank = below.sum(1)
    leaf_w = [empty] * (S + 2)
    leaf_sym = [0] * S
    for s in np.flatnonzero(used).tolist():
        leaf_w[rank[s]] = int(f[s])
        leaf_sym[rank[s]] = s
    # 2. the merge: n - 1 steps, a leaf winning a tie
    node_w = [empty] * S
    parent = [0] * S
    nleaf = [0] * S
    leaf_parent = [0] * S
    lp = nh = 0
    for s in range(n - 1):
        lf0, lf1, nf0, nf1 = leaf_w[lp], leaf_w[lp + 1], node_w[nh], \
            node_w[nh + 1]
        t1 = lf0 <= nf0
        x, y = (lf1, nf0) if t1 else (lf0, nf1)
        t2 = x <= y
        node_w[s] = (lf0 if t1 else nf0) + (x if t2 else y)
        if not t1:
            parent[nh] = s
        if not t2:
            parent[nh + (not t1)] = s
        for k in range(lp, lp + t1 + t2):
            leaf_parent[k] = s
        nleaf[s] = t1 + t2
        lp += t1 + t2
        nh += 2 - t1 - t2
    # 3. node depths, the root first: a node's parent is made later
    depth = [0] * S
    for c in range(n - 3, -1, -1):
        depth[c] = depth[parent[c]] + 1
    leaf_depth = np.zeros(S, np.int64)
    for k in range(n if n >= 2 else 0):
        leaf_depth[leaf_sym[k]] = depth[leaf_parent[k]] + 1
    cnt = [0] * (MAX_LEN + 1)
    for s in range(n - 1):
        cnt[min(depth[s] + 1, MAX_LEN)] += nleaf[s]
    # 4. one used symbol: a 1-bit code
    if n == 1:
        cnt[1] = 1
    # 5. the Kraft repair
    kraft = sum(cnt[l] << (MAX_LEN - l) for l in range(1, MAX_LEN + 1))
    while kraft > 1 << MAX_LEN:
        lsel = max([l for l in range(1, MAX_LEN) if cnt[l] > 0], default=0)
        cnt[lsel] -= 1
        cnt[lsel + 1] += 1
        kraft -= 1 << (MAX_LEN - 1 - lsel)
    for l in range(MAX_LEN - 1, 0, -1):
        cnt[l] += cnt[l + 1]
    # 6. lengths, longest first to the rarest leaves
    lengths = np.zeros(S, np.int64)
    for k in range(n):
        l = MAX_LEN
        while l >= 1 and k >= cnt[l]:
            l -= 1
        lengths[leaf_sym[k]] = l
    # 7. codes: fc[len] + the rank among the symbols of its length, from
    # each segment's counts and the rank inside the segment
    seg = np.zeros((S // SEG, MAX_LEN + 1), np.int64)
    for g in range(S // SEG):
        seg[g] = np.bincount(lengths[g * SEG:(g + 1) * SEG],
                             minlength=MAX_LEN + 1)
    fc, code = [0] * (MAX_LEN + 1), 0
    for l in range(1, MAX_LEN + 1):
        fc[l] = code
        code = ((code + int(seg[:, l].sum())) << 1) & 0xFFFFFFFF
    codes = np.zeros(S, np.int64)
    for s in np.flatnonzero(lengths).tolist():
        l, g = lengths[s], s // SEG
        intra = int((lengths[g * SEG:s] == l).sum())
        codes[s] = (fc[l] + int(seg[:g, l].sum()) + intra) & 0xFFFFFFFF
    codes = codes.astype(np.uint32).view(np.int32)
    return lengths.astype(np.int32), codes, leaf_depth


def _zipf(r, k):
    return np.minimum(r.zipf(1.3, (k, S)) - 1, 60000)


def _seeded(r, k):
    """Rows of every density: a share of the symbols used, counts of
    several scales."""
    rows = np.zeros((k, S), np.int64)
    for i in range(k):
        share = r.uniform(0.005, 1.0)
        scale = int(10 ** r.uniform(0, 4.5))
        rows[i] = np.where(r.random(S) < share, r.integers(1, scale + 1, S), 0)
    return rows


def case_rows(name):
    """int32 [k, 512] symbol counts of one case."""
    r = np.random.default_rng(sum(map(ord, name)))
    rows = np.zeros((4, S), np.int64)
    if name == "empty":
        rows = rows[:1]
    elif name == "one_symbol":  # symbols 0, 511 and two between
        for i, s in enumerate((0, 511, 137, 256)):
            rows[i, s] = (1, 7, 65536, 300)[i]
    elif name == "two_symbols":
        rows[0, [0, 511]] = [5, 5]
        rows[1, [3, 4]] = [1, 1000]
        rows[2, [300, 2]] = [9, 2]
        rows[3, [510, 511]] = [65536, 1]
    elif name == "equal_counts":  # all 512 used, every tie taken
        rows[0], rows[1], rows[2], rows[3] = 1, 3, 128, 65536 // 512
    elif name == "fibonacci":  # trees deeper than 15: the repair runs
        rows = _fib_freqs().numpy().astype(np.int64)
        deep = np.zeros((3, S), np.int64)
        for i in range(3):
            a, b = 1, 1
            for s in r.choice(S, 26 + 4 * i, replace=False):
                deep[i, s] = a
                a, b = b, a + b
        rows = np.concatenate([rows, deep])
    elif name == "single_65536":
        rows = rows[:1]
        rows[0, 65] = 65536
    elif name == "zipf":
        rows = _zipf(r, 6)
    elif name == "near_2_21":  # sums just below 2^30, the empty slot's cost
        rows = (1 << 21) - r.integers(1, 4096, (3, S))
        rows[2, ::3] = 0
    elif name == "seeded":
        rows = _seeded(r, 200)
    else:
        raise ValueError(name)
    return torch.from_numpy(rows.astype(np.int32))


CASES = ("empty", "one_symbol", "two_symbols", "equal_counts", "fibonacci",
         "single_65536", "zipf", "near_2_21", "seeded")


@pytest.fixture(scope="module")
def models():
    return {name: [model(row) for row in case_rows(name).numpy()]
            for name in CASES}


@pytest.mark.parametrize("name", CASES)
def test_model_matches_the_plain_version(name, models):
    freqs = case_rows(name)
    lengths, codes = huffman.huffman_tables_ref(freqs)
    assert lengths.dtype == codes.dtype == torch.int32
    want_len = huffman.huffman_code_lengths(freqs)
    want_codes = huffman.canonical_from_lengths(want_len)[0]
    assert torch.equal(lengths, want_len) and torch.equal(codes, want_codes)
    for k, (m_len, m_codes, _) in enumerate(models[name]):
        np.testing.assert_array_equal(m_len, lengths[k].numpy(), str(k))
        np.testing.assert_array_equal(m_codes, codes[k].numpy(), str(k))
    assert int(lengths.max()) <= MAX_LEN


@pytest.mark.parametrize("name", CASES)
def test_reverse_depth_pass_gives_the_merge_tree(name, models):
    """The reverse pass's leaf depths are those of a full binary tree
    (Kraft sum exactly 1) whose cost, the sum of weight times depth, is
    the sum of the merge's node weights: each node's weight is counted
    once for every leaf below it.  With no repair the lengths are those
    depths."""
    freqs = case_rows(name).numpy().astype(np.int64)
    for k, (m_len, _, depth) in enumerate(models[name]):
        f = freqs[k]
        n = int((f > 0).sum())
        if n < 2:
            assert not depth.any()
            continue
        d = depth[f > 0]
        assert d.min() >= 1
        assert sum(2.0 ** -int(x) for x in d) == 1.0
        # the merge's node weights sum to the tree's cost
        w = np.sort(f[f > 0])
        assert int((f * depth).sum()) == _huffman_cost(w)
        if d.max() <= MAX_LEN:
            np.testing.assert_array_equal(m_len, depth)


def _huffman_cost(w):
    """The sum of the node weights of any Huffman merge of ``w``."""
    import heapq

    heap = [int(x) for x in w]
    heapq.heapify(heap)
    cost = 0
    while len(heap) > 1:
        a = heapq.heappop(heap) + heapq.heappop(heap)
        cost += a
        heapq.heappush(heap, a)
    return cost


def test_model_matches_tpucomp(models):
    """Every case (each row's counts sum below 2^30), as one batch
    through tpucomp's ``huffman_code_lengths``."""
    import jax
    import jax.numpy as jnp
    from tpucomp.kernels import huffman as t_huff

    rows = torch.cat([case_rows(n) for n in CASES]).numpy()
    assert (rows.astype(np.int64).sum(1) < EMPTY).all()
    want = np.asarray(jax.jit(t_huff.huffman_code_lengths)(jnp.asarray(rows)))
    got = np.stack([m[0] for n in CASES for m in models[n]])
    np.testing.assert_array_equal(got, want)


def test_cpu_tensors_take_the_plain_version():
    """The wrapper's dispatch; its counters on this path are held in
    ``test_torch_trace.py``, which opens the profiler sessions."""
    freqs = case_rows("fibonacci")
    before = huffman.huffman_tables.launches
    lengths, codes = huffman.huffman_tables(freqs)
    assert torch.equal(lengths, huffman.huffman_code_lengths(freqs))
    assert torch.equal(codes, huffman.canonical_from_lengths(lengths)[0])
    assert huffman.huffman_tables.launches == before
    empty = huffman.huffman_tables(torch.zeros((0, S), dtype=torch.int32))
    assert [list(t.shape) for t in empty] == [[0, S], [0, S]]


@pytest.mark.parametrize("bad", [torch.zeros((2, S), dtype=torch.int64),
                                 torch.zeros((2, S - 1), dtype=torch.int32),
                                 torch.zeros(S, dtype=torch.int32)])
def test_wrapper_refuses_other_shapes_and_types(bad):
    with pytest.raises(ValueError):
        huffman.huffman_tables(bad)


def test_large_counts_hold_the_empty_slot_cost():
    """The ``near_2_21`` rows sum to just below 2^30, the one constant
    that is both the empty slot's cost and the bound of a row's sum: with
    it halved they would come out otherwise, so the card tests on these
    rows hold the kernel's constant.  A row summing to 2^30 is outside
    the domain (-1), one below it is not."""
    freqs = case_rows("near_2_21")
    sums = freqs.long().sum(1)
    assert ((sums >= EMPTY // 2) & (sums < EMPTY)).all()
    assert EMPTY == huffman._INF
    want = huffman.huffman_code_lengths(freqs).numpy()
    for k, row in enumerate(freqs.numpy()):
        np.testing.assert_array_equal(model(row)[0], want[k])
        assert not np.array_equal(model(row, empty=EMPTY // 2)[0], want[k])
    over = np.zeros(S, np.int64)
    over[:2] = [1 << 29, 1 << 29]
    assert (model(over)[0] == -1).all() and (model(over)[1] == -1).all()
    over[1] -= 1
    np.testing.assert_array_equal(
        model(over)[0], huffman.huffman_code_lengths(
            torch.from_numpy(over[None].astype(np.int32)))[0].numpy())

"""Huffman code lengths and canonical tables of Xpress Huffman, in plain
PyTorch.

Counterparts of ``tpucomp/kernels/huffman.py`` ``huffman_code_lengths``,
``canonical_from_lengths`` and ``rank_to_symbol_table`` (XLA in tpucomp,
so plain tensor code here), of ``codecs/xpress_huff._unpack_table``, and
of the table prep that ``xh_pallas.parse_records`` does before its kernel
([MS-XCA] §2.1.2).

:func:`huffman_tables` builds the encoder's tables (lengths and codes) of
every row: on CUDA tensors in one launch of ``csrc/huffman_tables.cu``, a
block a row; on CPU tensors by :func:`huffman_tables_ref`, the plain
functions below.

A symbol's canonical rank is its place in (length, symbol) order.  Per
code length l (1..15), ``fc[l]`` is the first code of that length,
``br[l]`` the rank of its first symbol and ``lim[l] = fc[l] + cnt[l]``.
"""

from __future__ import annotations

import torch

from .. import stats
from ..stats import count, span
from ..util import any_set
from . import _build

MAX_CODE_LEN = 15
NUM_SYMBOLS = 512
_INF = 1 << 30  # tpucomp's cost of an empty queue slot or an unused leaf


def huffman_code_lengths(freqs: torch.Tensor) -> torch.Tensor:
    """int32 [N, 512] symbol counts -> int32 [N, 512] code lengths (0 for
    an unused symbol, at most 15), tpucomp's ``huffman_code_lengths``:

    - leaves in (freq, symbol) order, unused symbols last;
    - the two-queue merge, a leaf winning a tie with a node;
    - each leaf's depth in the merge tree;
    - a row with one used symbol gives it a 1-bit code; an empty row
      gives all zeros;
    - the Kraft repair to 15 bits: while the depth profile
      oversubscribes, one leaf moves from the deepest level under 15 one
      level down;
    - the repaired lengths go longest first to the rarest leaves.

    tpucomp sorts ``(freq, sym)`` on the frequency alone with an
    unstable sort; here the key ``freq << 9 | sym`` is unique, so ties
    go by symbol whatever the sort.
    """
    N, S = freqs.shape
    dev = freqs.device
    i64 = dict(dtype=torch.int64, device=dev)
    used = freqs > 0
    n_used = used.sum(1)
    sym = torch.arange(S, **i64)
    skey = (torch.where(used, freqs.long(), 1 << 31) << 9 | sym).sort(1).values
    leaf_sym = skey & (S - 1)
    leaf_freq = torch.where((skey >> 9) < (1 << 31), skey >> 9, _INF)

    # the two-queue merge: step s makes node s from the two cheapest of
    # (leaf lp, leaf lp + 1, node nh, node nh + 1).  One row of ``q`` holds
    # the sorted leaves, two empty slots, then the nodes, every slot not
    # filled costing _INF (a node not made yet too).  Only the first
    # n_used - 1 steps of a row make a node; its later steps change
    # nothing that is read, their positions merely kept inside ``q``.  A
    # step keeps only its two choices (leaf or node); the queue positions
    # follow from them after the loop.  The loop launches few ops a step:
    # on the card each costs more host time than device time.  Each step
    # is a span of its own (``huffman.merge_step``), so that a trace names
    # the host time between its ops.
    OFF = S + 2
    q = torch.cat([leaf_freq, torch.full((N, S + 3), _INF, **i64)], 1)
    # (lp + 1, nh, lp, nh + 1) as columns of q: their values are (lf1, nf0,
    # lf0, nf1), so the second pick compares columns 0:2 or 2:4
    pos = torch.tensor([1, OFF, 0, OFF + 1], **i64).repeat(N, 1)
    cap = torch.tensor([S + 1, 2 * S + 2, S + 1, 2 * S + 2], **i64)
    move = torch.tensor([[0, 2, 0, 2], [1, 1, 1, 1], [2, 0, 2, 0]], **i64)
    with span("sync.huffman_steps", "sync"):
        steps = max(int(n_used.max()) - 1, 0) if N else 0
    count("huffman.merge_steps", steps)
    took = torch.zeros((N, max(steps, 1), 2), dtype=torch.bool, device=dev)
    for s in range(steps):
        with span("huffman.merge_step", "compute"):
            v = q.gather(1, pos)
            t1 = v[:, 2] <= v[:, 1]  # leaf lp against node nh
            ab = torch.where(t1[:, None], v[:, 0:2], v[:, 2:4])
            t12 = torch.stack([t1, ab[:, 0] <= ab[:, 1]], 1)
            q[:, OFF + s] = torch.minimum(v[:, 2], v[:, 1]) + ab.amin(1)
            took[:, s] = t12
            pos = torch.minimum(pos + move[t12.sum(1)], cap)
    made = torch.arange(max(steps, 1), **i64) < (n_used[:, None] - 1)
    t1, t2 = took[:, :, 0] & made, took[:, :, 1] & made
    # every made step consumes two queue heads: before step s, lp leaves
    # and 2 s - lp nodes are gone
    taken = t1.long() + t2.long()
    lp = taken.cumsum(1) - taken
    nh = 2 * torch.arange(took.shape[1], **i64) - lp
    i1 = torch.where(t1, lp, nh)
    i2 = torch.where(t2, lp + t1.long(), nh + (~t1).long())

    # node depths: a node's parent is the step that consumed it; the root
    # is node n_used - 2 at depth 0.  Pointer jumping, 9 rounds for chains
    # of up to 511 nodes.
    col = torch.arange(S + 1, **i64).expand(N, -1)
    parent = col.clone()
    parent.scatter_(1, torch.where(made & ~t1, i1, S), col[:, :t1.shape[1]])
    parent.scatter_(1, torch.where(made & ~t2, i2, S), col[:, :t2.shape[1]])
    parent[:, S] = S
    depth = (parent != col).long()
    for _ in range(9):
        depth = depth + depth.gather(1, parent)
        parent = parent.gather(1, parent)
    # a leaf sits one below the node that consumed it
    dd = depth[:, :t1.shape[1]] + 1
    leaf_depth = torch.zeros((N, S + 1), **i64)
    leaf_depth.scatter_(1, torch.where(t1, i1, S), dd)
    leaf_depth.scatter_(1, torch.where(t2, i2, S), dd)
    k = torch.arange(S, **i64)
    leaf_depth = torch.where(n_used[:, None] <= 1, (k == 0).long(),
                             leaf_depth[:, :S])

    # the 15-bit repair on the count of leaves per depth
    depths = torch.where(k < n_used[:, None], leaf_depth.clamp(max=15), 0)
    lvl = torch.arange(MAX_CODE_LEN + 1, **i64)
    cnt = torch.zeros((N, MAX_CODE_LEN + 1), **i64)
    cnt.scatter_add_(1, depths, (depths > 0).long())
    weight = 1 << (MAX_CODE_LEN - lvl)
    rounds = 0
    over = (cnt * weight).sum(1) > (1 << MAX_CODE_LEN)
    while any_set(over, "sync.huffman_repair"):
        with span("huffman.repair_round", "compute"):
            has = (cnt > 0) & (lvl < MAX_CODE_LEN) & (lvl > 0)
            lsel = torch.where(has, lvl, 0).amax(1, keepdim=True)
            cnt = (cnt - ((lvl == lsel) & over[:, None]).long()
                   + ((lvl == lsel + 1) & over[:, None]).long())
            over = (cnt * weight).sum(1) > (1 << MAX_CODE_LEN)
        rounds += 1
    count("huffman.repair_rounds", rounds)

    # leaf k (k-th rarest) gets the k-th of 15 x cnt[15], 14 x cnt[14], ...
    from_deep = cnt.flip(1).cumsum(1).flip(1)
    length = torch.zeros((N, S), **i64)
    for l in range(MAX_CODE_LEN, 0, -1):
        length = torch.where((length == 0) & (k < from_deep[:, l:l + 1]), l,
                             length)
    length = torch.where(k < n_used[:, None], length, 0)
    out = torch.zeros((N, S), dtype=torch.int32, device=dev)
    return out.scatter_(1, leaf_sym, length.to(torch.int32))


def huffman_tables_ref(freqs: torch.Tensor):
    """Plain PyTorch version of :func:`huffman_tables`:
    :func:`huffman_code_lengths`, then the codes of
    :func:`canonical_from_lengths`."""
    lengths = huffman_code_lengths(freqs)
    return lengths, canonical_from_lengths(lengths)[0]


def huffman_tables(freqs: torch.Tensor):
    """int32 [N, 512] symbol counts -> (lengths, codes), int32 [N, 512]
    each: every row's Huffman code lengths (:func:`huffman_code_lengths`)
    and canonical codes (those of :func:`canonical_from_lengths`).

    A row's counts must sum below 2^30, the cost of an empty queue slot
    (tpucomp's bound; a row of XH symbols holds at most 65536).  On the
    card a row at or above it gets lengths and codes of -1.

    On the card one launch builds every row, with no host step that
    depends on the data; it counts ``huffman.kernel_rows`` and, since the
    host issues no merge step, ``huffman.merge_steps`` 0."""
    if freqs.dtype != torch.int32 or freqs.dim() != 2 \
            or freqs.shape[1] != NUM_SYMBOLS:
        raise ValueError(f"huffman_tables takes int32 [N, {NUM_SYMBOLS}] "
                         f"counts, got {freqs.dtype} {list(freqs.shape)}")
    if not _build.use_kernel(freqs):
        return huffman_tables_ref(freqs)
    src = freqs.contiguous()
    lengths = torch.empty_like(src)
    codes = torch.empty_like(src)
    N = src.shape[0]
    count("huffman.merge_steps", 0)
    count("huffman.kernel_rows", N)
    if N:
        _build.launch("huffman_tables", [src, lengths, codes], [N])
        stats.launched(huffman_tables)
    return lengths, codes


huffman_tables.launches = 0


def unpack_table(payload: torch.Tensor) -> torch.Tensor:
    """[N, P] stream bytes -> int32 [N, 512] code lengths from the 256-byte
    table prefix: symbol 2i has the low nibble of byte i, 2i + 1 the high."""
    tb = payload[:, :256].to(torch.int32)
    return torch.stack([tb & 0xF, (tb >> 4) & 0xF], dim=2).reshape(
        tb.shape[0], NUM_SYMBOLS)


def _rank_order(lengths: torch.Tensor) -> torch.Tensor:
    """Symbols in canonical rank order, [N, 512] int64.  The sort key
    ``len << 10 | sym`` is unique (unused symbols sort last, by symbol),
    so the order does not depend on the sort's stability."""
    sym = torch.arange(NUM_SYMBOLS, device=lengths.device)
    key = torch.where(lengths > 0, lengths.long(), MAX_CODE_LEN + 1) << 10 | sym
    return key.sort(dim=1).indices


def canonical_from_lengths(lengths: torch.Tensor):
    """(codes [N, 512], fc, br, lim [N, 16]), all int32, as tpucomp's
    ``canonical_from_lengths``: the code of every used symbol (0 for an
    unused one) and the per-level first code, base rank and limit."""
    N = lengths.shape[0]
    dev = lengths.device
    lvl = torch.arange(MAX_CODE_LEN + 1, device=dev)
    cnt = ((lengths[:, :, None] == lvl) & (lengths[:, :, None] > 0)).sum(
        dim=1).to(torch.int32)  # [N, 16]
    fc = torch.zeros((N, MAX_CODE_LEN + 1), dtype=torch.int32, device=dev)
    br = torch.zeros_like(fc)
    code = torch.zeros(N, dtype=torch.int32, device=dev)
    rank = torch.zeros_like(code)
    for l in range(1, MAX_CODE_LEN + 1):
        fc[:, l] = code
        br[:, l] = rank
        code = (code + cnt[:, l]) << 1
        rank = rank + cnt[:, l]
    lim = fc + cnt
    # a used symbol's code: fc[len] + (its rank - br[len])
    order = _rank_order(lengths)
    r = torch.empty_like(order)
    r.scatter_(1, order, torch.arange(NUM_SYMBOLS, device=dev).expand(N, -1))
    ln = lengths.long()
    codes = fc.gather(1, ln) + (r.to(torch.int32) - br.gather(1, ln))
    return torch.where(lengths > 0, codes, 0), fc, br, lim


def rank_to_symbol_table(lengths: torch.Tensor) -> torch.Tensor:
    """int32 [N, 512]: canonical rank -> symbol; ranks at or past the count
    of used symbols map to 0."""
    order = _rank_order(lengths).to(torch.int32)
    used = (lengths > 0).sum(dim=1, keepdim=True)
    rank = torch.arange(NUM_SYMBOLS, device=lengths.device)
    return torch.where(rank < used, order, 0)


def level_tables(fc: torch.Tensor, br: torch.Tensor, lim: torch.Tensor):
    """The parse's per-level tables (``xh_pallas.parse_records`` prep):
    ``LIM15[l] = lim[l] << (15 - l)``, the level's limit scaled to 15 bits,
    and ``rbf[l] = br[l] - fc[l]``, so that a code of level l read as its
    top l bits ``c`` has rank ``rbf[l] + c``.  Both int32 [N, 16]."""
    lvl = torch.arange(MAX_CODE_LEN + 1, dtype=torch.int32, device=fc.device)
    return lim << (MAX_CODE_LEN - lvl), br - fc

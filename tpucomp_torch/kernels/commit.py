"""The greedy parse: a cursor walk that commits one token at a time.

Counterpart of ``tpucomp/kernels/lz_pallas.py`` ``greedy_commit`` and
``greedy_commit_layout``, and of their XLA forms
(``tpucomp.kernels.common.greedy_commit`` and the commit+layout scan of
``tpucomp.codecs.lznt1.encode_batch``).  Per row, walking p = 0..n-1 with
a cursor ``nc`` that starts at 0:

  - ``committed[p] = (p == nc) & okpos[p]``;
  - a committed p moves the cursor to ``p + best_len[p]`` when
    ``is_match[p]``, else to ``p + 1``;
  - layout: ``t_after[p]`` counts the committed positions up to and
    including p, ``data_before[p]`` the data bytes (2 per committed
    match, 1 per committed literal) strictly before p.

:func:`greedy_commit` and :func:`greedy_commit_layout` launch
``csrc/greedy_commit.cu`` (one kernel, a layout flag) on CUDA tensors and
run :func:`greedy_commit_ref` on CPU tensors.  tpucomp's kernel packs the
commit bits 32 to a word; both packages return them unpacked, as bool.

The committed positions are the chain 0 -> next(0) -> ..., next(p) = p +
(best_len[p] if is_match[p] else 1), which ends at a position that cannot
commit, and after one whose jump is 0 or less or reaches n.  Chains from
different starts that meet are equal from there on, so the kernel walks
a row in segments of :data:`SEG` positions at once, each from its own
first position, then repairs in rounds the segments whose entry (the
largest exit of the segments before) changed, until none changes: at
most one round a segment (:func:`segments`), about 4 a row on the corpus
of ``chip_smoke.py``.  Each wrapper keeps the round count of every row
of its last launch as ``rounds`` (int32 [N] on the card), as it keeps
``launches``.  Rows on the card have at most :data:`MAX_ROW` positions
(the kernel stores jumps as uint16).
"""

from __future__ import annotations

import torch

from .. import stats
from . import _build

SEG = 128  # positions a thread of the kernel walks: csrc/greedy_commit.cu
MAX_ROW = 1 << 16


def segments(n: int) -> int:
    """The segments of a row of n positions: the most rounds it can take."""
    return -(-n // SEG)


def _check(is_match, best_len, okpos):
    if is_match.dtype != torch.bool or is_match.dim() != 2:
        raise ValueError("is_match must be a bool [N, n] tensor")
    if best_len.dtype != torch.int32 or best_len.shape != is_match.shape:
        raise ValueError("best_len must be an int32 tensor shaped as is_match")
    if okpos.dtype != torch.bool or okpos.shape != is_match.shape:
        raise ValueError("okpos must be a bool tensor shaped as is_match")


def greedy_commit_ref(is_match, best_len, okpos, layout: bool = False):
    """Plain PyTorch version of both walks: a Python loop over positions
    on [N] tensors, like tpucomp's scan.  Returns ``committed`` alone, or
    ``(committed, t_after, data_before)`` with ``layout``."""
    _check(is_match, best_len, okpos)
    N, n = is_match.shape
    i32 = dict(dtype=torch.int32, device=is_match.device)
    nc, tcnt, dbytes = (torch.zeros(N, **i32) for _ in range(3))
    committed = torch.zeros((N, n), dtype=torch.bool, device=is_match.device)
    t_after = torch.zeros((N, n), **i32)
    data_before = torch.zeros((N, n), **i32)
    step = torch.where(is_match, best_len, 1)
    for p in range(n):
        commit = (nc == p) & okpos[:, p]
        nc = torch.where(commit, p + step[:, p], nc)
        committed[:, p] = commit
        if layout:
            data_before[:, p] = dbytes
            tcnt = tcnt + commit
            dbytes = dbytes + commit * (1 + is_match[:, p].int())
            t_after[:, p] = tcnt
    return (committed, t_after, data_before) if layout else committed


def _walk(is_match, best_len, okpos, layout: bool):
    _check(is_match, best_len, okpos)
    if not all(t.is_contiguous() for t in (is_match, best_len, okpos)):
        raise ValueError("is_match, best_len and okpos must be contiguous")
    N, n = is_match.shape
    if n > MAX_ROW:
        raise ValueError(f"rows of at most {MAX_ROW} positions, not {n}")
    dev = is_match.device
    committed = torch.empty((N, n), dtype=torch.bool, device=dev)
    t_after = torch.empty((N, n) if layout else (0,), dtype=torch.int32,
                          device=dev)
    data_before = torch.empty_like(t_after)
    rounds = torch.ones(N, dtype=torch.int32, device=dev)
    launched = bool(N and n)
    if launched:
        _build.launch("greedy_commit",
                      [is_match, best_len, okpos, committed, t_after,
                       data_before, rounds], [N, n, int(layout)])
    return launched, committed, t_after, data_before, rounds


def greedy_commit(is_match: torch.Tensor, best_len: torch.Tensor,
                  okpos: torch.Tensor) -> torch.Tensor:
    """The commit bit of every position (bool [N, n]).

    Args: ``is_match`` bool [N, n], ``best_len`` int32 [N, n] (the jump
    of a match), ``okpos`` bool [N, n] (positions that may commit); all
    contiguous on the card.
    """
    if not _build.use_kernel(is_match, best_len, okpos):
        return greedy_commit_ref(is_match, best_len, okpos)
    launched, committed, _, _, rounds = _walk(is_match, best_len, okpos,
                                              False)
    if launched:
        stats.launched(greedy_commit)
    greedy_commit.rounds = rounds
    return committed


def greedy_commit_layout(is_match: torch.Tensor, best_len: torch.Tensor,
                         okpos: torch.Tensor):
    """:func:`greedy_commit` plus the LZNT1 stream-layout prefix sums.

    Returns ``(committed bool [N, n], t_after int32 [N, n], data_before
    int32 [N, n])``: see the module docstring.
    """
    if not _build.use_kernel(is_match, best_len, okpos):
        return greedy_commit_ref(is_match, best_len, okpos, layout=True)
    launched, committed, t_after, data_before, rounds = _walk(
        is_match, best_len, okpos, True)
    if launched:
        stats.launched(greedy_commit_layout)
    greedy_commit_layout.rounds = rounds
    return committed, t_after, data_before


greedy_commit.launches = 0
greedy_commit_layout.launches = 0
greedy_commit.rounds = None
greedy_commit_layout.rounds = None

"""The segment-parallel greedy walk of ``csrc/greedy_commit.cu``, as a
numpy model, against the plain walk ``commit.greedy_commit_ref``.

The model cuts a row into segments of ``commit.SEG`` positions, walks
each from its first position, then repairs in rounds the segments whose
entry changed, until no entry changes, as the kernel does.  A segment's
entry is the largest exit of the segments before it in the round before:
on the true chain the exits do not decrease, so that is the exit of the
segment just before, and a match that jumps over many segments reaches
all of them in one round.  It gives each row's round
count as the kernel defines it, so the card tests hold the kernel's
``rounds`` to it.  Every value is an integer or a bool: the tolerance is
exact equality.
"""

import numpy as np
import pytest
import torch

from tpucomp_torch.kernels import commit

INT32_MAX = np.iinfo(np.int32).max


def jumps(is_match, best_len, okpos):
    """next(p) - p for every position, 0 where the chain ends at p."""
    n = is_match.shape[-1]
    room = n - np.arange(n)
    step = np.where(is_match, best_len.astype(np.int64), 1)
    return np.where(okpos & (step > 0) & (step < room), step, 0)


def segment_walk(is_match, best_len, okpos, seg=commit.SEG):
    """The kernel's walk: (committed bool [N, n], rounds int32 [N])."""
    N, n = is_match.shape
    jump = jumps(is_match, best_len, okpos)
    nseg = -(-n // seg)
    committed = np.zeros((N, n), bool)
    rounds = np.zeros(N, np.int32)
    for i in range(N):
        j = jump[i].tolist()

        def walk(entry, t, old, old_exit):
            """(chain positions, exit) of segment t entered at entry, given
            its old chain; n as the exit: the chain has ended."""
            s1 = min((t + 1) * seg, n)
            p, new = entry, set()
            while p < s1:
                if p in old:  # met the old chain: equal from here on
                    return new | {q for q in old if q >= p}, old_exit
                new.add(p)
                if j[p] == 0:
                    return new, n
                p += j[p]
            return new, p

        last = [t * seg for t in range(nseg)]
        state = [walk(last[t], t, set(), n) for t in range(nseg)]
        r = 1
        while True:
            exits = np.maximum.accumulate([x for _, x in state]).tolist()
            entries = [0] + exits[:-1]
            changed = [t for t in range(nseg) if entries[t] != last[t]]
            if not changed:
                break
            r += 1
            for t in changed:
                state[t] = walk(entries[t], t, *state[t])
                last[t] = entries[t]
        rounds[i] = r
        for bits, _ in state:
            committed[i, sorted(bits)] = True
    return committed & okpos, rounds


def walk_rows(n, seed, wide=False):
    """Named walk inputs of width n: (names, is_match, best_len, okpos).

    Random matches, long jumps (to n and past it), a constant jump, a
    constant jump 2 after one literal (its chains never meet: one round a
    segment), zero lengths with is_match set, okpos holes mid-row, an
    all-false okpos row and all literals.  ``wide`` adds lengths tpucomp's
    kernel cannot take (it packs them in 20 bits): negative ones and
    INT32_MAX with is_match set, and a jump of n at p = 0.
    """
    r = np.random.default_rng(seed)
    rows = {}

    def row(name, is_match, best_len, okpos=None):
        rows[name] = (np.broadcast_to(is_match, (n,)),
                      np.broadcast_to(np.int32(best_len), (n,)),
                      np.broadcast_to(True if okpos is None else okpos, (n,)))

    row("random", r.random(n) < 0.35, r.integers(3, 60, n))
    row("long jumps", r.random(n) < 0.3, r.integers(1, 2 * n + 2, n))
    row("constant jump 37", True, 37)
    row("never meets", np.arange(n) > 0, 2)
    row("zero lengths", r.random(n) < 0.3,
        np.where(r.random(n) < 0.5, 0, r.integers(1, 9, n)))
    holes = np.ones(n, bool)
    holes[r.integers(0, n, max(1, n // 50))] = False
    holes[n // 3:n // 3 + 7] = False
    row("okpos holes", r.random(n) < 0.35, r.integers(2, 40, n), holes)
    row("okpos all false", r.random(n) < 0.35, r.integers(2, 40, n), False)
    row("all literals", False, 5)
    if wide:
        row("negative and INT32_MAX", r.random(n) < 0.5,
            r.choice(np.array([-1, -(1 << 31), INT32_MAX, 0, 1, 3, 17],
                              np.int64), n))
        row("jump of n at 0", np.arange(n) == 0, n)
    names = list(rows)
    is_match, best_len, okpos = (np.stack([rows[k][f] for k in names])
                                 for f in range(3))
    return names, is_match, best_len.astype(np.int32), okpos


def _ref(is_match, best_len, okpos):
    return commit.greedy_commit_ref(
        *(torch.from_numpy(np.ascontiguousarray(a))
          for a in (is_match, best_len, okpos)), layout=True)


@pytest.mark.parametrize("n", [1, 129, 1000, 4096])
def test_segment_walk_equals_the_plain_walk(n):
    names, *ins = walk_rows(n, seed=n, wide=True)
    com, rounds = segment_walk(*ins)
    want, t_after, data_before = (t.numpy() for t in _ref(*ins))
    np.testing.assert_array_equal(com, want)
    # the layout sums follow from the commit bits
    np.testing.assert_array_equal(np.cumsum(com, axis=1), t_after)
    dbytes = com * (1 + ins[0])
    np.testing.assert_array_equal(np.cumsum(dbytes, axis=1) - dbytes,
                                  data_before)
    nseg = commit.segments(n)
    assert (rounds >= 1).all() and (rounds <= nseg).all()
    by = dict(zip(names, rounds.tolist()))
    assert by["never meets"] == nseg
    # all literals: every segment starts on the chain; all false: the
    # segments after the first learn in round 1 that the chain has ended
    assert by["all literals"] == 1 and by["okpos all false"] == min(2, nseg)


def test_segment_walk_round_counts():
    """Rows whose round counts are known by hand, at 8 segments."""
    n = 8 * commit.SEG
    names, *ins = walk_rows(n, seed=3)
    com, rounds = segment_walk(*ins)
    np.testing.assert_array_equal(com, _ref(*ins)[0].numpy())
    by = dict(zip(names, rounds.tolist()))
    # 37 is prime and above 8: no segment start t * 128 is on the chain
    # k * 37 of the row, and the residues t * 128 mod 37 all differ
    assert by["constant jump 37"] == 8
    assert by["never meets"] == 8
    # a jump past n at 0: the chain is {0}, and every later segment learns
    # in round 1 that it has ended
    one = np.zeros((1, n), bool)
    one[0, 0] = True
    com, rounds = segment_walk(one, np.full((1, n), n, np.int32),
                               np.ones((1, n), bool))
    assert com.sum() == 1 and com[0, 0] and rounds.tolist() == [2]


def test_segments_and_row_limit():
    assert [commit.segments(n) for n in (1, 128, 129, 4096, 65536)] == [
        1, 1, 2, 32, 512]
    assert commit.MAX_ROW == 65536

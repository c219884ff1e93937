"""The sort-based hash match finder of the LZ encoders, in plain PyTorch
around the row-sort kernel.

Counterparts of ``tpucomp.kernels.common`` ``le_words``,
``hash_best_match`` and ``extend_saturated``, equal to them value for
value.  tpucomp sorts the hash key together with eight rolled copies of
the word plane (``shifted[t] = roll(w, -4t)``), a nine-plane sort; those
planes are rolls of one plane, so here only the key goes through
:func:`tpucomp_torch.kernels.sort.sort_rows` and the words are gathered
through the sorted positions: ``sw[t][i] == w[(spos[i] + 4t) mod n]``.
The un-sort back to position order is the same kernel on two planes.

All hashing is uint32 arithmetic in tpucomp; here it runs in int64 and
is reduced mod 2^32 before every product can pass 2^63.
"""

from __future__ import annotations

import torch

from .sort import sort_rows

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B1  # the chain key's multiplicative hash
MIX5 = 0x85EBCA6B  # mixes bytes 3 and 4 into the 5-byte seed


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 ``a`` in [0, 2^32) and a 32-bit ``b``,
    without an int64 product past 2^48."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & M32


def le_words(x: torch.Tensor) -> torch.Tensor:
    """w[p] = the little-endian 4-byte word starting at byte p of each
    row (int32, wrapping: bytes past the row's end come from its start,
    as ``jnp.roll`` gives them; callers mask the wrapped words)."""
    x = x.long()
    w = (x | (x.roll(-1, 1) << 8) | (x.roll(-2, 1) << 16)
         | (x.roll(-3, 1) << 24))
    return w.to(torch.int32)  # int64 -> int32 keeps the low 32 bits


def hash_keys(x: torch.Tensor, hash_bits: int, pos_bits: int,
              seed: int = 3) -> torch.Tensor:
    """The chain sort key ``(h << pos_bits) | p`` of every position, int32,
    where h hashes the 3 (or, ``seed`` 5, 5) bytes from p (wrapping)."""
    n = x.shape[1]
    x = x.long()
    tri = x | (x.roll(-1, 1) << 8) | (x.roll(-2, 1) << 16)
    if seed == 5:
        hi = x.roll(-3, 1) | (x.roll(-4, 1) << 8)
        tri = tri ^ ((hi * MIX5) & M32)
    h = _mul32(tri, GOLDEN) >> (32 - hash_bits)
    pos = torch.arange(n, device=x.device)
    return ((h << pos_bits) | pos).to(torch.int32)


def sorted_words(w: torch.Tensor, spos: torch.Tensor, nwords: int):
    """The words of each sorted position: ``sw[t][i] = w[(spos[i] + 4t)
    mod n]``, the planes tpucomp's nine-plane sort carries along."""
    n = w.shape[1]
    return [w.gather(1, ((spos + 4 * t) % n).long()) for t in range(nwords)]


def _agree_bytes(v: torch.Tensor) -> torch.Tensor:
    """Equal low-order bytes of two little-endian words, from their XOR
    ``v``: 4 where v == 0, else the trailing zero bytes of v (tpucomp's
    ``tz >> 3`` with ``tz`` the trailing zero bits)."""
    return (((v & 0xFF) == 0).int() + ((v & 0xFFFF) == 0).int()
            + ((v & 0xFFFFFF) == 0).int() + (v == 0).int())


def hash_best_match_sorted(x: torch.Tensor, n: int, hash_bits: int = 13,
                           num_cands: int = 2, cap: int = 16,
                           pos_bits=None, max_disp=None, seed: int = 3):
    """:func:`hash_best_match` up to its un-sort: returns ``spos`` (the
    positions in hash-sorted order, a permutation of each row), the
    packed ``((disp - 1) << len_bits) | len`` in that order, and
    ``len_bits``."""
    N = x.shape[0]
    if pos_bits is None:
        pos_bits = max(1, (n - 1).bit_length())
    nwords = cap // 4
    (skey,) = sort_rows((hash_keys(x, hash_bits, pos_bits, seed),))
    spos = skey & ((1 << pos_bits) - 1)
    sh = skey >> pos_bits
    sw = sorted_words(le_words(x), spos, nwords)
    idx = torch.arange(n, device=x.device)
    best_len = torch.zeros((N, n), dtype=torch.int32, device=x.device)
    best_disp = torch.ones((N, n), dtype=torch.int32, device=x.device)
    for k in range(1, num_cands + 1):
        cand = spos.roll(k, 1)
        ok = (idx >= k) & (sh.roll(k, 1) == sh)
        if max_disp is not None:  # format window (e.g. XPRESS 8 KiB)
            ok = ok & (spos - cand <= max_disp)
        total = torch.zeros((N, n), dtype=torch.int32, device=x.device)
        alive = ok
        for t in range(nwords):
            off = 4 * t
            v = sw[t] ^ sw[t].roll(k, 1)
            clip = ((spos + off) > (n - 4)) | ((cand + off) > (n - 4))
            agree = torch.where(clip, 0, _agree_bytes(v))
            total = total + torch.where(alive, agree, 0)
            alive = alive & (v == 0) & ~clip
        ml = torch.where(ok, total, 0)
        better = ok & (ml > best_len)
        best_len = torch.where(better, ml, best_len)
        best_disp = torch.where(better, spos - cand, best_disp)
    len_bits = max(1, int(cap).bit_length())
    packed = ((best_disp - 1) << len_bits) | best_len
    return spos, packed, len_bits


def hash_best_match(x: torch.Tensor, n: int, hash_bits: int = 13,
                    num_cands: int = 2, cap: int = 16, pos_bits=None,
                    max_disp=None, seed: int = 3):
    """Best hash-chain match per position: ``(best_len, best_disp)``, int32
    [N, n], the longest match, capped at ``cap`` bytes and counted in
    whole words that lie inside the row, among the ``num_cands`` most
    recent earlier positions of the same hash (ties: the most recent);
    (0, 1) where there is none.  ``x`` is uint8 [N, n]; ``seed`` is the
    number of bytes hashed (3 or 5); ``max_disp`` bounds the displacement.
    """
    if seed not in (3, 5):
        raise ValueError(f"hash_best_match: seed must be 3 or 5, got {seed}")
    N, nx = x.shape
    if nx != n:
        raise ValueError(f"hash_best_match: x is {nx} wide, n is {n}")
    if num_cands <= 0:
        return (torch.zeros((N, n), dtype=torch.int32, device=x.device),
                torch.ones((N, n), dtype=torch.int32, device=x.device))
    spos, packed, len_bits = hash_best_match_sorted(
        x, n, hash_bits, num_cands, cap, pos_bits, max_disp, seed)
    _, out = sort_rows((spos, packed))
    return out & ((1 << len_bits) - 1), (out >> len_bits) + 1


def extend_saturated(length: torch.Tensor, disp: torch.Tensor, cap: int,
                     n=None) -> torch.Tensor:
    """Exact lengths for cap-saturated hash matches, by stride doubling:
    where ``length[p]`` reached ``cap`` and the finder at ``p + stride``
    chose the same displacement, the two verified agreements concatenate.
    Every round reads the previous round's whole ``acc`` and ``alive``."""
    nx = length.shape[1]
    if n is None:
        n = nx
    pos = torch.arange(nx, device=length.device)
    acc = length
    alive = length >= cap
    stride = cap
    while stride < n:
        ok = alive & (pos + stride < n) & (disp.roll(-stride, 1) == disp)
        acc = acc + torch.where(ok, acc.roll(-stride, 1), 0)
        alive = ok & alive.roll(-stride, 1)
        stride *= 2
    return acc

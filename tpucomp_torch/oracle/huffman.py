"""Length-limited canonical Huffman codes (shared oracle primitive).

Capability parity target: reference ``include/mscomp/HuffmanEncoder.h`` /
``HuffmanDecoder.h`` (SURVEY.md §2 row 8; mount unavailable).  The encode
side uses the package-merge algorithm, which produces *optimal* length-
limited codes — any valid reference encoder's table is no better, so the
"≤ reference size" bar is safe on this component.

Canonical assignment ([MS-XCA] §2.1.2): sort symbols by (code length,
symbol index); codes increase numerically, shorter codes first::

    code[k] = (code[k-1] + 1) << (len[k] - len[k-1])

Bit order: the ``len``-bit code value is written MSB-first to the bitstream.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ..errors import DataError


def package_merge(freqs: Sequence[int], limit: int) -> List[int]:
    """Optimal length-limited code lengths for ``freqs`` (0 = unused symbol).

    Returns a list of code lengths (0 for unused symbols), each ≤ ``limit``.
    Deterministic: ties break on (freq, lowest symbol set).
    """
    items = sorted((f, (s,)) for s, f in enumerate(freqs) if f > 0)
    n = len(items)
    if n == 0:
        return [0] * len(freqs)
    if n == 1:
        lengths = [0] * len(freqs)
        lengths[items[0][1][0]] = 1
        return lengths
    if n > (1 << limit):
        raise DataError("too many symbols for code length limit")
    leaves = [(f, syms) for f, syms in items]
    level: List[Tuple[int, tuple]] = list(leaves)
    for _ in range(limit - 1):
        packaged = [
            (level[i][0] + level[i + 1][0], level[i][1] + level[i + 1][1])
            for i in range(0, len(level) - 1, 2)
        ]
        level = sorted(leaves + packaged)
    counts: Dict[int, int] = {}
    for _, syms in level[: 2 * (n - 1)]:
        for s in syms:
            counts[s] = counts.get(s, 0) + 1
    lengths = [0] * len(freqs)
    for s, c in counts.items():
        lengths[s] = c
    return lengths


def canonical_codes(lengths: Sequence[int]) -> List[int]:
    """Canonical code values from code lengths (0-length symbols get 0)."""
    order = sorted(
        (l, s) for s, l in enumerate(lengths) if l > 0
    )  # (length, symbol), shorter first
    codes = [0] * len(lengths)
    code = 0
    prev_len = 0
    for l, s in order:
        code <<= l - prev_len
        codes[s] = code
        code += 1
        prev_len = l
    if prev_len and code > (1 << prev_len):
        raise DataError("over-subscribed canonical code lengths")
    return codes


def build_decode_table(lengths: Sequence[int], peek_bits: int) -> List[int]:
    """Flat peek table: index = next ``peek_bits`` bits (MSB-first) →
    packed ``(symbol << 4) | code_length``.  All lengths must be ≤ peek_bits.
    Unused entries are -1 (decoding into them is a data error).
    """
    codes = canonical_codes(lengths)
    table = [-1] * (1 << peek_bits)
    for s, l in enumerate(lengths):
        if l == 0:
            continue
        if l > peek_bits:
            raise DataError("code length exceeds peek width")
        base = codes[s] << (peek_bits - l)
        span = 1 << (peek_bits - l)
        packed = (s << 4) | l
        for j in range(base, base + span):
            table[j] = packed
    return table

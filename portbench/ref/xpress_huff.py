"""The benchmark's plain Xpress Huffman decoder ([MS-XCA] §2.1-2.2), in
NumPy, for units of one block (at most 65536 decoded bytes) each.

It decodes every unit in lockstep: each step reads one symbol in every
unit that has output left to make, with its offset bits and length
bytes, and copies a match byte by byte as the format defines it (see
:func:`portbench.ref.lznt1.copy_matches`, whose ``block_copies`` control
it takes too).  It imports nothing of the code under test.
"""

from __future__ import annotations

import numpy as np

from .lznt1 import copy_matches

MAXLEN = 15
MASK32 = np.uint64(0xFFFFFFFF)


def lookup_tables(tables: np.ndarray) -> np.ndarray:
    """The 32768-entry decode table of each unit from its 256-byte code
    length table ([B, 256] uint8): entry ``(symbol << 4) | length`` for
    the 15-bit prefixes of the symbol's canonical code, -1 for none.
    Raises ValueError on over-subscribed lengths."""
    lens = np.zeros((len(tables), 512), np.int64)
    lens[:, 0::2] = tables & 0xF
    lens[:, 1::2] = tables >> 4
    span = np.where(lens > 0, 1 << (MAXLEN - lens), 0)
    if np.any(span.sum(1) > 1 << MAXLEN):
        raise ValueError("XH: over-subscribed code lengths")
    lut = np.full((len(tables), 1 << MAXLEN), -1, np.int64)
    for b in range(len(tables)):
        # canonical codes in (length, symbol) order: each code's
        # 15-bit prefixes follow the previous code's
        order = np.lexsort((np.arange(512), lens[b]))
        order = order[lens[b, order] > 0]
        entries = np.repeat((order << 4) | lens[b, order], span[b, order])
        lut[b, :len(entries)] = entries
    return lut


def decode_units(streams: list, out_lens: list,
                 block_copies: bool = False) -> list:
    """Each unit's decoded bytes; raises ValueError where one is
    malformed."""
    B = len(streams)
    in_len = np.array([len(s) for s in streams], np.int64)
    if np.any(in_len < 256):
        raise ValueError("XH: unit shorter than its table")
    width = int(in_len.max()) + 16
    buf = np.zeros((B, width), np.uint8)
    for b, s in enumerate(streams):
        buf[b, :len(s)] = np.frombuffer(s, np.uint8)
    lut = lookup_tables(buf[:, :256])
    flat_in = buf.reshape(-1)
    in_base = np.arange(B, dtype=np.int64) * width
    end = np.array(out_lens, np.int64)
    out = np.zeros((B, max(1, int(end.max()))), np.uint8)
    flat = out.reshape(-1)
    out_base = np.arange(B, dtype=np.int64) * out.shape[1]

    def u16(lanes, p):
        q = in_base[lanes] + np.minimum(p, width - 2)
        return (flat_in[q].astype(np.uint64)
                | (flat_in[q + 1].astype(np.uint64) << np.uint64(8)))

    lanes = np.arange(B)
    p = np.full(B, 256 + 4, np.int64)
    bits = (u16(lanes, p - 4) << np.uint64(16)) | u16(lanes, p - 2)
    count = np.full(B, 32, np.int64)
    o = np.zeros(B, np.int64)

    def take(a, n):
        """Drop ``n`` bits from lanes ``a``, refilling 16 when fewer than
        16 are left."""
        bits[a] = (bits[a] << n.astype(np.uint64)) & MASK32
        count[a] -= n
        r = a[count[a] < 16]
        bits[r] |= u16(r, p[r]) << (16 - count[r]).astype(np.uint64)
        p[r] += 2
        count[r] += 16

    act = lanes[o < end]
    while act.size:
        e = lut[act, (bits[act] >> np.uint64(17)).astype(np.int64) & 0x7FFF]
        if np.any(e < 0):
            raise ValueError("XH: no code for the next bits")
        take(act, e & 0xF)
        sym = e >> 4
        lit, m, sym_m = act[sym < 256], act[sym >= 256], sym[sym >= 256] - 256
        flat[out_base[lit] + o[lit]] = sym[sym < 256]
        o[lit] += 1
        if m.size:
            obc = sym_m >> 4
            length = sym_m & 0xF
            off = (1 << obc) | (bits[m] >> (32 - obc).astype(np.uint64)
                                ).astype(np.int64) * (obc > 0)
            take(m, obc)
            long_ = m[length == 15]
            if long_.size:
                if np.any(p[long_] >= in_len[long_]):
                    raise ValueError("XH: length byte past the end")
                b = flat_in[in_base[long_] + p[long_]].astype(np.int64)
                p[long_] += 1
                ext = b + 15
                w = b == 255
                if np.any(w):
                    lw = long_[w]
                    v = u16(lw, p[lw]).astype(np.int64)
                    p[lw] += 2
                    z = v == 0
                    if np.any(z):
                        lz = lw[z]
                        if np.any(p[lz] + 4 > in_len[lz]):
                            raise ValueError("XH: length word past the end")
                        v[z] = (u16(lz, p[lz]) | (u16(lz, p[lz] + 2)
                                << np.uint64(16))).astype(np.int64)
                        p[lz] += 4
                    ext[w] = v
                length[length == 15] = ext
            length = length + 3
            if np.any(off > o[m]) or np.any(o[m] + length > end[m]):
                raise ValueError("XH: match outside its unit")
            copy_matches(flat, out_base[m] + o[m], off, length, block_copies)
            o[m] += length
        act = act[o[act] < end[act]]
    return [out[b, :end[b]].tobytes() for b in range(B)]

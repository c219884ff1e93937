"""The benchmark's plain LZXPRESS decoder ([MS-XCA] §2.3-2.4, plain LZ77),
in NumPy, for independent unit streams of known decoded length.

It decodes every unit in lockstep: each step takes one flag bit in every
unit that has output left to make, reading a fresh 32-bit little-endian
flag word first where the last one is spent (bits taken from the most
significant down, 1 for a match), then a literal byte, or a match token
with its length escapes, whose match it copies byte by byte as the
format defines it (see :func:`portbench.ref.lznt1.copy_matches`, whose
``block_copies`` control it takes too).  It imports nothing of the code
under test.

A match token is a 16-bit little-endian word: the offset less one in its
top 13 bits, the length less 3 in its low 3.  Where those 3 bits are 7,
the length goes on in a shared nibble: the first such match reads a
fresh byte and takes its low half, the next takes the high half of that
same byte.  A nibble of 15 goes on in a byte; a byte of 255 gives way to
a 16-bit word holding the whole length less 3, and a word of 0 to a
32-bit one.  The lengths are whole numbers here, as in the specification
(no 32-bit register wraps): a length that reaches past its unit is
malformed, however large.
"""

from __future__ import annotations

import numpy as np

from .lznt1 import copy_matches


def decode_units(streams: list, out_lens: list,
                 block_copies: bool = False) -> list:
    """Each unit stream's decoded bytes, ``out_lens[i]`` of unit i; raises
    ValueError where one is malformed (a field past the stream's end, a
    long length word under 22, a match before its unit's start or past
    its end)."""
    B = len(streams)
    if B == 0:
        return []
    in_len = np.array([len(s) for s in streams], np.int64)
    width = max(1, int(in_len.max()))
    buf = np.zeros((B, width), np.uint8)
    for b, s in enumerate(streams):
        buf[b, :len(s)] = np.frombuffer(s, np.uint8)
    flat_in = buf.reshape(-1)
    in_base = np.arange(B, dtype=np.int64) * width
    end = np.array(out_lens, np.int64)
    out = np.zeros((B, max(1, int(end.max()))), np.uint8)
    flat = out.reshape(-1)
    out_base = np.arange(B, dtype=np.int64) * out.shape[1]

    def read(lanes, nbytes, what):
        """The little-endian field of ``nbytes`` at each lane's input
        position, which it passes; raises where one is past the end."""
        if np.any(ip[lanes] + nbytes > in_len[lanes]):
            raise ValueError(f"Xpress: {what} past the end of the stream")
        q = in_base[lanes] + ip[lanes]
        v = np.zeros(len(lanes), np.int64)
        for k in range(nbytes):
            v |= flat_in[q + k].astype(np.int64) << (8 * k)
        ip[lanes] += nbytes
        return v

    ip = np.zeros(B, np.int64)
    o = np.zeros(B, np.int64)
    flags = np.zeros(B, np.int64)
    nflags = np.zeros(B, np.int64)
    nib_at = np.full(B, -1, np.int64)  # the half-used nibble byte, or -1
    act = np.nonzero(o < end)[0]
    while act.size:
        spent = act[nflags[act] == 0]
        flags[spent] = read(spent, 4, "flag word")
        nflags[spent] = 32
        nflags[act] -= 1
        match = (flags[act] >> nflags[act]) & 1 == 1
        lit, m = act[~match], act[match]
        flat[out_base[lit] + o[lit]] = read(lit, 1, "literal")
        o[lit] += 1
        if m.size:
            tok = read(m, 2, "match token")
            off = (tok >> 3) + 1
            length = tok & 7
            esc = np.nonzero(length == 7)[0]
            if esc.size:
                le = m[esc]
                opens = nib_at[le] < 0
                nib = np.zeros(len(le), np.int64)
                lo = le[opens]
                nib_at[lo] = ip[lo]
                nib[opens] = read(lo, 1, "length nibble") & 0xF
                hi = le[~opens]
                nib[~opens] = flat_in[in_base[hi] + nib_at[hi]] >> 4
                nib_at[hi] = -1
                k = np.nonzero(nib == 15)[0]
                if k.size:
                    lk = le[k]
                    byte = read(lk, 1, "length byte")
                    w = np.nonzero(byte == 255)[0]
                    if w.size:
                        lw = lk[w]
                        word = read(lw, 2, "length word")
                        z = np.nonzero(word == 0)[0]
                        if z.size:
                            word[z] = read(lw[z], 4, "long length word")
                        if np.any(word < 15 + 7):
                            raise ValueError("Xpress: long length under 22")
                        byte[w] = word - (15 + 7)
                    nib[k] = byte + 15
                length[esc] = nib + 7
            length = length + 3
            if np.any(off > o[m]) or np.any(o[m] + length > end[m]):
                raise ValueError("Xpress: match outside its unit")
            copy_matches(flat, out_base[m] + o[m], off, length, block_copies)
            o[m] += length
        act = act[o[act] < end[act]]
    return [out[b, :end[b]].tobytes() for b in range(B)]

"""The benchmark's plain LZNT1 decoder ([MS-XCA] §2.5), in NumPy.

It walks every compressed chunk of a stream in lockstep: each step reads
one flag byte or one token in every chunk that has one left, and copies a
match byte by byte as the format defines it (a source that overlaps its
destination repeats the bytes before it).  It imports nothing of the code
under test.

``block_copies=True`` is the control: each match is copied as one block,
as a memmove would copy it, which breaks the bit-exact decode wherever a
match overlaps its own output.

LZNT1 streams end by themselves: :func:`decode_units` decodes a batch's
unit streams as one joined stream and cuts it back into units.
"""

from __future__ import annotations

import numpy as np

CHUNK = 4096


def _shifts() -> np.ndarray:
    """The offset field's width at each position of a chunk: 12 less the
    bits of ``position - 1`` above its low 4."""
    out = np.zeros(CHUNK + 1, np.int64)
    for pos in range(CHUNK + 1):
        s, q = 0, pos - 1
        while q >= 0x10:
            s, q = s + 1, q >> 1
        out[pos] = 12 - s
    return out


D_SHIFT = _shifts()


def chunks(stream: bytes):
    """(payload start, payload size, compressed) of each chunk, up to a
    0x0000 header or the end; raises ValueError on a chunk cut short."""
    starts, sizes, comp = [], [], []
    i, n = 0, len(stream)
    while i + 2 <= n:
        header = stream[i] | (stream[i + 1] << 8)
        i += 2
        if header == 0:
            break
        size = (header & 0xFFF) + 1
        if i + size > n:
            raise ValueError("LZNT1: chunk payload past the end")
        starts.append(i)
        sizes.append(size)
        comp.append(bool(header & 0x8000))
        i += size
    return (np.array(starts, np.int64), np.array(sizes, np.int64),
            np.array(comp, bool))


def copy_matches(flat: np.ndarray, dst: np.ndarray, disp: np.ndarray,
                 length: np.ndarray, block_copies: bool) -> None:
    """Copy each match ``k`` of ``length[k]`` bytes from ``dst[k] -
    disp[k]`` to ``dst[k]`` in ``flat``: byte i of a match reads
    ``dst - disp + i % disp``, the byte the format's byte-by-byte copy
    reads (or ``dst - disp + i`` with ``block_copies``)."""
    first = np.cumsum(length) - length
    owner = np.repeat(np.arange(len(length)), length)
    i = np.arange(int(length.sum())) - first[owner]
    d = disp[owner]
    src = dst[owner] - d + (i if block_copies else i % d)
    flat[dst[owner] + i] = flat[src]


def decode(stream: bytes, block_copies: bool = False) -> bytes:
    """The bytes ``stream`` decodes to; raises ValueError where it is
    malformed (a token past its chunk, a match before the chunk's start
    or past its 4096 bytes)."""
    buf = np.frombuffer(stream, np.uint8)
    starts, sizes, comp = chunks(stream)
    out = np.zeros((len(starts), CHUNK), np.uint8)
    olen = np.zeros(len(starts), np.int64)
    for k in np.nonzero(~comp)[0]:
        if sizes[k] > CHUNK:
            raise ValueError("LZNT1: stored chunk over 4096 bytes")
        out[k, :sizes[k]] = buf[starts[k]:starts[k] + sizes[k]]
        olen[k] = sizes[k]
    lane = np.nonzero(comp)[0]
    ip, end = starts[lane].copy(), starts[lane] + sizes[lane]
    op = np.zeros(len(lane), np.int64)
    flags = np.zeros(len(lane), np.int64)
    bit = np.full(len(lane), 8)
    flat = out.reshape(-1)
    base = lane * CHUNK
    act = np.arange(len(lane))
    while act.size:
        act = act[ip[act] < end[act]]
        a = act[bit[act] == 8]
        flags[a] = buf[ip[a]]
        ip[a] += 1
        bit[a] = 0
        act = act[ip[act] < end[act]]
        if not act.size:
            break
        match = (flags[act] >> bit[act]) & 1 == 1
        lit, m = act[~match], act[match]
        if np.any(op[lit] >= CHUNK):
            raise ValueError("LZNT1: literal past the chunk's end")
        flat[base[lit] + op[lit]] = buf[ip[lit]]
        ip[lit] += 1
        op[lit] += 1
        if m.size:
            if np.any(ip[m] + 2 > end[m]):
                raise ValueError("LZNT1: token cut short")
            tok = buf[ip[m]].astype(np.int64) | (buf[ip[m] + 1].astype(
                np.int64) << 8)
            ip[m] += 2
            shift = D_SHIFT[op[m]]
            length = (tok & ((1 << shift) - 1)) + 3
            disp = (tok >> shift) + 1
            if np.any(disp > op[m]) or np.any(op[m] + length > CHUNK):
                raise ValueError("LZNT1: match outside its chunk")
            copy_matches(flat, base[m] + op[m], disp, length, block_copies)
            op[m] += length
        bit[act] += 1
    olen[lane] = op
    return out[np.arange(CHUNK) < olen[:, None]].tobytes()


def decode_units(streams: list, out_lens: list,
                 block_copies: bool = False) -> list:
    """Each unit stream's decoded bytes: the streams decode as one joined
    stream, cut back into units at ``out_lens`` (a unit of another length
    shows as wrong bytes).  Raises ValueError on a malformed stream."""
    joined = decode(b"".join(streams), block_copies)
    out, at = [], 0
    for n in out_lens:
        out.append(joined[at:at + n])
        at += n
    if at != len(joined):
        out[-1] += joined[at:]
    return out

"""LZNT1 oracle codec — spec-exact transcription of [MS-XCA] §2.5.

Capability parity target: reference ``src/lznt1_compress.cpp`` /
``src/lznt1_decompress.cpp`` (SURVEY.md §2 row 3; mount unavailable —
semantics are grounded in the public [MS-XCA] spec instead, SURVEY.md §8.1).

Format summary ([MS-XCA] §2.5, SURVEY.md §8.1):

* Input is split into chunks of up to CHUNK_SIZE = 4096 uncompressed bytes.
* Each stored chunk is prefixed by a 2-byte LE header::

      header = (payload_len - 1) | 0x3000 | (0x8000 if compressed else 0)

  where ``payload_len`` counts the bytes following the header for this chunk.
  A 0x0000 header word (or end of input) terminates the stream.
* A compressed chunk body is a sequence of groups: 1 flag byte followed by up
  to 8 tokens; flag bit i (LSB-first) says token i is a copy token (1) or a
  literal byte (0).
* A copy token is a u16 LE holding ``(disp - 1) << d_shift | (len - 3)``.
  The split between displacement and length bits depends on the current
  output position ``p`` inside the chunk::

      l_mask = 0xFFF; d_shift = 12; q = p - 1
      while q >= 0x10: l_mask >>= 1; d_shift -= 1; q >>= 1

  Matches may not reach before the chunk start; copies may overlap
  (forward byte-at-a-time semantics).
"""

from __future__ import annotations

from ..errors import ArgError, DataError

CHUNK_SIZE = 4096
MIN_MATCH = 3


def _split_for_pos(p: int):
    """Return (l_mask, d_shift) for output position ``p`` within a chunk."""
    l_mask = 0xFFF
    d_shift = 12
    q = p - 1
    while q >= 0x10:
        l_mask >>= 1
        d_shift -= 1
        q >>= 1
    return l_mask, d_shift


def max_compressed_size(n: int) -> int:
    """Worst-case compressed size for ``n`` input bytes (SURVEY.md §8.5).

    Per chunk: 2-byte header + stored-raw payload; plus 2 terminator bytes.
    """
    nchunks = (n + CHUNK_SIZE - 1) // CHUNK_SIZE
    return n + 2 * max(nchunks, 1) + 2


def _compress_chunk(chunk: bytes) -> bytes:
    """Greedy LZ77 parse of one chunk into LZNT1 token/flag groups."""
    n = len(chunk)
    out = bytearray()
    table: dict = {}  # 3-byte prefix -> list of positions (hash chain)
    pos = 0
    while pos < n:
        flag = 0
        flag_pos = len(out)
        out.append(0)
        for bit in range(8):
            if pos >= n:
                break
            l_mask, d_shift = _split_for_pos(pos)
            max_len = min(l_mask + 3, n - pos)
            best_len = 0
            best_disp = 0
            if pos + MIN_MATCH <= n:
                key = chunk[pos : pos + 3]
                for cand in reversed(table.get(key, ())):
                    # length of common prefix chunk[cand:] vs chunk[pos:]
                    length = 0
                    while (
                        length < max_len
                        and chunk[cand + length] == chunk[pos + length]
                    ):
                        length += 1
                    if length > best_len:
                        best_len = length
                        best_disp = pos - cand
                        if length >= max_len:
                            break
            if best_len >= MIN_MATCH:
                tok = ((best_disp - 1) << d_shift) | (best_len - 3)
                out += tok.to_bytes(2, "little")
                flag |= 1 << bit
                end = min(pos + best_len, n - 2)
                for q in range(pos, end):
                    table.setdefault(chunk[q : q + 3], []).append(q)
                pos += best_len
            else:
                out.append(chunk[pos])
                if pos + 3 <= n:
                    table.setdefault(chunk[pos : pos + 3], []).append(pos)
                pos += 1
        out[flag_pos] = flag
    return bytes(out)


def compress(data: bytes, *, emit_terminator: bool = False) -> bytes:
    """Compress ``data`` to an LZNT1 stream.

    Each 4096-byte chunk is stored raw when LZ77 does not shrink it
    (reference behavior: per-chunk stored-raw fallback, SURVEY.md §3.1).
    """
    data = bytes(data)
    out = bytearray()
    for start in range(0, len(data), CHUNK_SIZE):
        chunk = data[start : start + CHUNK_SIZE]
        payload = _compress_chunk(chunk)
        if len(payload) < len(chunk):
            header = 0xB000 | (len(payload) - 1)
        else:
            payload = chunk
            header = 0x3000 | (len(payload) - 1)
        out += header.to_bytes(2, "little")
        out += payload
    if emit_terminator:
        out += b"\x00\x00"
    return bytes(out)


def decompress(data: bytes, out_len: int | None = None) -> bytes:
    """Decompress an LZNT1 stream.

    ``out_len`` (if given) bounds the output; LZNT1 is self-terminating at
    chunk granularity so it may be omitted (unlike Xpress formats).
    """
    data = bytes(data)
    out = bytearray()
    i = 0
    n = len(data)
    while i + 2 <= n:
        header = data[i] | (data[i + 1] << 8)
        i += 2
        if header == 0:
            break
        size = (header & 0xFFF) + 1
        if i + size > n:
            raise DataError("LZNT1: chunk payload extends past end of input")
        chunk_start = len(out)
        if not (header & 0x8000):
            out += data[i : i + size]
            i += size
        else:
            end = i + size
            while i < end:
                flags = data[i]
                i += 1
                for bit in range(8):
                    if i >= end:
                        break
                    if flags & (1 << bit):
                        if i + 2 > end:
                            raise DataError("LZNT1: truncated copy token")
                        tok = data[i] | (data[i + 1] << 8)
                        i += 2
                        p = len(out) - chunk_start
                        l_mask, d_shift = _split_for_pos(p)
                        length = (tok & l_mask) + MIN_MATCH
                        disp = (tok >> d_shift) + 1
                        if disp > p:
                            raise DataError(
                                "LZNT1: copy reaches before chunk start"
                            )
                        for _ in range(length):
                            out.append(out[-disp])
                    else:
                        out.append(data[i])
                        i += 1
            if len(out) - chunk_start > CHUNK_SIZE:
                raise DataError("LZNT1: chunk decompressed past 4096 bytes")
        if out_len is not None and len(out) >= out_len:
            break
    result = bytes(out)
    if out_len is not None:
        if len(result) < out_len:
            raise DataError("LZNT1: stream ended before out_len bytes")
        result = result[:out_len]
    return result

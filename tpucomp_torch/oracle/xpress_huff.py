"""LZ77+Huffman "Xpress Huffman" oracle codec — [MS-XCA] §2.1–2.2.

Capability parity target: reference ``src/xpress_huff_compress.cpp`` /
``src/xpress_huff_decompress.cpp`` (SURVEY.md §2 row 5; mount unavailable —
grounded in [MS-XCA], SURVEY.md §8.3).

Format summary:

* Uncompressed data is processed in BLOCK_SIZE = 65536-byte blocks; each
  block has its own canonical Huffman table over 512 symbols.
* Symbols 0–255 = literal bytes.  Symbols 256–511 = matches::

      sym - 256 = (offset_bit_count << 4) | length_header
      offset_bit_count = floor(log2(offset))        # offset >= 1
      length_header    = min(len - 3, 15)

* After a match symbol the decoder reads ``offset_bit_count`` raw bits and
  computes ``offset = (1 << offset_bit_count) | raw_bits``; then, when
  ``length_header == 15``, length-escape *bytes* from the byte stream::

      len = byte + 15 + 3           (byte < 255)
      len = u16 + 3                 (byte == 255; u16 != 0)
      len = u32 + 3                 (byte == 255, u16 == 0)

  Raw-bit reads for the offset happen BEFORE the length-escape bytes
  (interop order used by battle-tested decoders of this format).
* Each block starts with a 256-byte table: 512 × 4-bit code lengths
  (0 = unused, else 1–15); symbol 2i in the LOW nibble of byte i, 2i+1 in
  the high nibble.
* Bitstream: bits written MSB-first into 16-bit *little-endian* words.
  The decoder primes with two u16 reads (32-bit window) and refills one u16
  whenever fewer than 16 valid bits remain.  Escape bytes / u16 / u32 are
  read from the current byte position, interleaved with the bit words.
* No EOF marker: symbol 256 is a real match symbol (offset 1, length 3 —
  ``obc=0, length_header=0``), so it cannot double as a terminator.  The
  decoder stops at the expected output size; at internal block boundaries it
  recovers the byte position of the next block's table deterministically
  from the exact count of bits and raw bytes consumed (see
  :func:`_block_byte_span`).

Window: matches may reach up to 65535 bytes back, across block boundaries.
This oracle's *encoder* restricts matches to the current block (valid
streams, marginally larger near block starts); the *decoder* accepts
cross-block references.
"""

from __future__ import annotations

from ..errors import ArgError, DataError
from .huffman import build_decode_table, canonical_codes, package_merge

BLOCK_SIZE = 65536
NUM_SYMBOLS = 512
EOF_SYMBOL = 256
MAX_CODE_LEN = 15
MIN_MATCH = 3
MAX_OFFSET = 65535


def max_compressed_size(n: int) -> int:
    """Safe worst-case bound (SURVEY.md §8.5): per block, 256-byte table +
    ≤2 bytes per input byte + flush slack."""
    nblocks = max(1, (n + BLOCK_SIZE - 1) // BLOCK_SIZE)
    return nblocks * (256 + 8) + 2 * n + 4


class _BitWriter:
    """MSB-first bit writer over 16-bit LE words with interleaved raw bytes.

    Two word slots are reserved ahead of the data bytes (mirroring the
    decoder's two-u16 priming read).  Flushing is LAZY: a word is emitted
    only once *more than* 16 bits are pending.  This is required for the
    interleave to line up with the spec's reader (which holds 16–32 valid
    bits and refills only when fewer than 16 remain): with an eager flush at
    exactly 16 pending bits, the writer would reserve a word slot *before* a
    raw escape byte that the reader consumes *before* refilling, and the two
    sides would disagree on the byte layout.
    """

    def __init__(self, out: bytearray):
        self.out = out
        self.bitbuf = 0
        self.bitcount = 0
        self.slot0 = len(out)
        out += b"\x00\x00"
        self.slot1 = len(out)
        out += b"\x00\x00"

    def write_bits(self, value: int, nbits: int):
        if nbits == 0:
            return
        self.bitbuf = ((self.bitbuf << nbits) | (value & ((1 << nbits) - 1)))
        self.bitcount += nbits
        while self.bitcount > 16:
            self.bitcount -= 16
            word = (self.bitbuf >> self.bitcount) & 0xFFFF
            self.out[self.slot0 : self.slot0 + 2] = word.to_bytes(2, "little")
            self.slot0 = self.slot1
            self.slot1 = len(self.out)
            self.out += b"\x00\x00"

    def write_byte(self, b: int):
        self.out.append(b & 0xFF)

    def write_u16(self, v: int):
        self.out += (v & 0xFFFF).to_bytes(2, "little")

    def write_u32(self, v: int):
        self.out += (v & 0xFFFFFFFF).to_bytes(4, "little")

    def flush(self):
        """Pad to a 16-bit boundary; leave reserved slots zeroed."""
        if self.bitcount:
            word = (self.bitbuf << (16 - self.bitcount)) & 0xFFFF
            self.out[self.slot0 : self.slot0 + 2] = word.to_bytes(2, "little")
        # remaining reserved slot(s) stay zero — harmless padding the decoder
        # may or may not consume before the expected output size is reached.


class _BitReader:
    """MSB-first bit reader mirroring _BitWriter; reads past end yield 0.

    Matches the [MS-XCA] §2.2.4 pseudocode: prime with two u16 (32-bit
    window); after consuming, refill one u16 whenever fewer than 16 valid
    bits remain.  Tracks bits and raw bytes consumed so the caller can
    compute the exact byte span of a block (:func:`_block_byte_span`) —
    ``self.pos`` itself may lag the writer by one word at block end.
    """

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.bits_consumed = 0
        self.raw_bytes_consumed = 0
        self.bitbuf = (self._u16() << 16) | self._u16()
        self.bitcount = 32

    def _u16(self) -> int:
        d, p = self.data, self.pos
        b0 = d[p] if p < len(d) else 0
        b1 = d[p + 1] if p + 1 < len(d) else 0
        self.pos = p + 2
        return b0 | (b1 << 8)

    def peek(self, nbits: int) -> int:
        return (self.bitbuf >> (32 - nbits)) & ((1 << nbits) - 1)

    def skip(self, nbits: int):
        self.bitbuf = (self.bitbuf << nbits) & 0xFFFFFFFF
        self.bitcount -= nbits
        self.bits_consumed += nbits
        if self.bitcount < 16:
            self.bitbuf |= self._u16() << (16 - self.bitcount)
            self.bitcount += 16

    def read_bits(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        v = self.peek(nbits)
        self.skip(nbits)
        return v

    def read_byte(self) -> int:
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        self.raw_bytes_consumed += 1
        return b

    def read_u16_raw(self) -> int:
        self.raw_bytes_consumed += 2
        return self._u16()

    def read_u32_raw(self) -> int:
        self.raw_bytes_consumed += 4
        lo = self._u16()
        hi = self._u16()
        return lo | (hi << 16)


def _block_byte_span(bits_consumed: int, raw_bytes_consumed: int) -> int:
    """Exact byte length of a block's post-table region as the writer laid
    it out: 2 initial word slots + one slot per lazy 16-bit flush, plus the
    interleaved raw bytes.  ``f = max(0, ceil(bits/16) - 1)`` lazy flushes.
    """
    flushes = max(0, -(-bits_consumed // 16) - 1)
    return 2 * (2 + flushes) + raw_bytes_consumed


def _log2_floor(v: int) -> int:
    return v.bit_length() - 1


def _lz_parse(data: bytes, start: int, end: int, *, max_chain: int = 96,
              table=None):
    """Greedy LZ77 parse of data[start:end].

    The window is confined to the block unless ``table`` is passed in
    (persistent across blocks): then matches reach up to MAX_OFFSET
    back across block boundaries ([MS-XCA] §2.1 cross-block window).
    Match OUTPUT extents stay block-confined either way.

    Yields tokens: (literal_byte, -1, -1) or (-1, length, offset).
    """
    tokens = []
    if table is None:
        table = {}
    pos = start
    n = end
    while pos < n:
        best_len = 0
        best_off = 0
        if pos + MIN_MATCH <= n:
            key = bytes(data[pos : pos + 3])
            chain = table.get(key, ())
            tried = 0
            for cand in reversed(chain):
                if pos - cand > MAX_OFFSET:
                    break
                tried += 1
                if tried > max_chain:
                    break
                length = 0
                limit = n - pos
                while length < limit and data[cand + length] == data[pos + length]:
                    length += 1
                if length > best_len:
                    best_len = length
                    best_off = pos - cand
                    if length >= limit:
                        break
        if best_len >= MIN_MATCH:
            tokens.append((-1, best_len, best_off))
            stop = min(pos + best_len, n - 2)
            step = 1 if best_len < 1024 else best_len
            for q in range(pos, stop, step):
                table.setdefault(bytes(data[q : q + 3]), []).append(q)
            pos += best_len
        else:
            tokens.append((data[pos], -1, -1))
            if pos + 3 <= n:
                table.setdefault(bytes(data[pos : pos + 3]), []).append(pos)
            pos += 1
    return tokens


def _match_symbol(length: int, offset: int) -> int:
    obc = _log2_floor(offset)
    lh = min(length - MIN_MATCH, 15)
    return 256 + ((obc << 4) | lh)


def compress(data: bytes, *, max_chain: int = 96,
             cross_block: bool = False) -> bytes:
    """Compress ``data`` as a sequence of 64 KiB Huffman blocks.

    ``cross_block=True``: matches reach up to 65535 back ACROSS block
    boundaries ([MS-XCA] §2.1 — the reference encoder's window), giving
    better ratios near block starts; False (default) confines matches
    to their block, matching the TPU block-parallel encoder bit-for-bit
    test expectations.  Both emit standard streams; this module's
    decompress (and the TPU one-shot decode's history window) take
    either."""
    data = bytes(data)
    out = bytearray()
    n = len(data)
    shared_table: dict = {} if cross_block else None
    nblocks = max(1, (n + BLOCK_SIZE - 1) // BLOCK_SIZE)
    for bi in range(nblocks):
        start = bi * BLOCK_SIZE
        end = min(start + BLOCK_SIZE, n)
        _compress_block(data, start, end, out, max_chain=max_chain,
                        table=shared_table)
    return bytes(out)


def _compress_block(data, start, end, out: bytearray, *, max_chain=96,
                    table=None):
    """Encode data[start:end] as one Huffman block appended to ``out``
    (table + bitstream); ``table`` as in :func:`_lz_parse`."""
    tokens = _lz_parse(data, start, end, max_chain=max_chain, table=table)
    # --- histogram over 512 symbols ---
    freqs = [0] * NUM_SYMBOLS
    for lit, length, off in tokens:
        if lit >= 0:
            freqs[lit] += 1
        else:
            freqs[_match_symbol(length, off)] += 1
    lengths = package_merge(freqs, MAX_CODE_LEN)
    codes = canonical_codes(lengths)
    # --- 256-byte nibble-packed table ---
    for i in range(256):
        lo = lengths[2 * i]
        hi = lengths[2 * i + 1]
        out.append(lo | (hi << 4))
    # --- bitstream ---
    bw = _BitWriter(out)
    for lit, length, off in tokens:
        if lit >= 0:
            bw.write_bits(codes[lit], lengths[lit])
        else:
            sym = _match_symbol(length, off)
            bw.write_bits(codes[sym], lengths[sym])
            obc = _log2_floor(off)
            bw.write_bits(off & ((1 << obc) - 1), obc)
            L = length - MIN_MATCH
            if L >= 15:
                rem = L - 15
                if rem < 255:
                    bw.write_byte(rem)
                else:
                    bw.write_byte(255)
                    if 0 < L < 0x10000:
                        bw.write_u16(L)
                    else:
                        bw.write_u16(0)
                        bw.write_u32(L)
    bw.flush()


class StreamCompressor:
    """Incremental XH encoder with the cross-block match window carried
    across feeds (reference ``ms_deflate`` semantics, SURVEY.md §3.5).

    Output is bit-identical to one-shot ``compress(data,
    cross_block=True)`` for ANY feed slicing: the format's 64 KiB block
    granularity makes the parse independent of where feeds land (each
    complete block is emitted as soon as it is buffered; ``flush()``
    emits the partial final block).
    """

    def __init__(self, *, max_chain: int = 96, cross_block: bool = True):
        self.max_chain = max_chain
        self._table: dict = {} if cross_block else None
        self._data = bytearray()
        self._start = 0  # start of the next block within _data
        self._finished = False
        self.total_in = 0

    def compress(self, chunk: bytes) -> bytes:
        if self._finished:
            raise ArgError("compressor already flushed")
        self._data += bytes(chunk)
        self.total_in += len(chunk)
        out = bytearray()
        while len(self._data) - self._start >= BLOCK_SIZE:
            _compress_block(self._data, self._start,
                            self._start + BLOCK_SIZE, out,
                            max_chain=self.max_chain, table=self._table)
            self._start += BLOCK_SIZE
            self._rebase()
        return bytes(out)

    def flush(self) -> bytes:
        if self._finished:
            return b""
        self._finished = True
        out = bytearray()
        if len(self._data) > self._start or self.total_in == 0:
            _compress_block(self._data, self._start, len(self._data), out,
                            max_chain=self.max_chain, table=self._table)
        return bytes(out)

    def _rebase(self):
        """Keep one window (64 KiB) behind the next block; memory stays
        O(window + unparsed tail)."""
        cut = self._start - MAX_OFFSET - 1
        if cut < (1 << 20):
            return
        if self._table is not None:
            self._table = {
                k: [c - cut for c in ch if c >= cut]
                for k, ch in self._table.items()
                if ch and ch[-1] >= cut
            }
        del self._data[:cut]
        self._start -= cut


def _decode_block(data, pos: int, out: bytearray, out_len: int):
    """Decode ONE block starting at data[pos], appending to ``out``
    (which holds the preceding output — the cross-block reach-back
    window).  ``out_len``: total output target (blocks end at 64 KiB
    boundaries of it).  Returns the next block's ``pos``.

    Raises DataError on malformed input.  The bit reader zero-fills
    past the end of ``data``, so on a TRUNCATED buffer this may decode
    garbage without raising — callers that stream must check the
    returned span against the bytes actually available (see
    :class:`StreamDecompressor`)."""
    if pos + 256 > len(data):
        raise DataError("XpressHuff: truncated Huffman table")
    lengths = [0] * NUM_SYMBOLS
    for i in range(256):
        b = data[pos + i]
        lengths[2 * i] = b & 0xF
        lengths[2 * i + 1] = b >> 4
    pos += 256
    if not any(lengths):
        raise DataError("XpressHuff: empty Huffman table")
    table = build_decode_table(lengths, MAX_CODE_LEN)
    br = _BitReader(data, pos)
    block_end = min(len(out) + BLOCK_SIZE, out_len)
    while len(out) < block_end:
        entry = table[br.peek(MAX_CODE_LEN)]
        if entry < 0:
            raise DataError("XpressHuff: invalid Huffman code")
        sym = entry >> 4
        br.skip(entry & 0xF)
        if sym < 256:
            out.append(sym)
            continue
        m = sym - 256
        obc = m >> 4
        L = m & 0xF
        offset = (1 << obc) | br.read_bits(obc)
        if L == 15:
            b = br.read_byte()
            if b == 255:
                L = br.read_u16_raw()
                if L == 0:
                    L = br.read_u32_raw()
            else:
                L = b + 15
        length = L + MIN_MATCH
        if offset > len(out):
            raise DataError("XpressHuff: offset before start of output")
        if len(out) + length > out_len:
            raise DataError("XpressHuff: match overruns output size")
        for _ in range(length):
            out.append(out[-offset])
    # Next block's table starts byte-aligned after the writer's exact
    # layout (NOT br.pos, which may lag the writer by one un-refilled
    # word when bits_consumed is a multiple of 16).
    return pos + _block_byte_span(br.bits_consumed, br.raw_bytes_consumed)


def decompress(data: bytes, out_len: int) -> bytes:
    """Decode exactly ``out_len`` bytes, reading a fresh table per block."""
    if out_len is None:
        raise ArgError("XpressHuff: out_len is required")
    data = bytes(data)
    out = bytearray()
    pos = 0
    while len(out) < out_len:
        pos = _decode_block(data, pos, out, out_len)
    return bytes(out)


class StreamDecompressor:
    """Incremental XH decoder taking ARBITRARY byte slices (reference
    ``ms_inflate`` semantics).  ``out_len`` is the total uncompressed
    size; each 64 KiB block is emitted once its bytes are fully
    buffered (block spans are only discoverable by decoding —
    [MS-XCA] §2.1).  Cross-block back-references resolve against the
    carried 64 KiB output window."""

    def __init__(self, out_len: int):
        if out_len is None:
            raise ArgError("XpressHuff: out_len is required")
        self.out_len = out_len
        self._buf = bytearray()
        self._win = bytearray()  # last <= 64 KiB of emitted output
        self.total_out = 0
        self.total_in = 0

    def decompress(self, chunk: bytes) -> bytes:
        self._buf += bytes(chunk)
        self.total_in += len(chunk)
        produced = bytearray()
        while self.total_out < self.out_len:
            # decode in window coordinates: ``work`` holds the carried
            # window (always 0 or a full 64 KiB — total_out advances in
            # blocks) + this block's output; the out_len passed shifts
            # the block-end/overrun checks by the window length
            work = bytearray(self._win)
            wlen = len(work)
            try:
                nxt = _decode_block(self._buf, 0, work,
                                    wlen + self.out_len - self.total_out)
            except DataError:
                if len(self._buf) < 256:
                    break  # certainly just a partial table: wait
                # ambiguous: mid-block truncation and corruption look
                # the same until more bytes arrive (the bit reader
                # zero-fills) — wait; flush() reports if it never heals
                break
            if nxt > len(self._buf):
                break  # the reader zero-filled past the buffer: wait
            block = work[wlen:]
            produced += block
            self.total_out += len(block)
            self._win = work[-MAX_OFFSET - 1 :]
            del self._buf[:nxt]
        return bytes(produced)

    def flush(self) -> bytes:
        if self.total_out < self.out_len:
            raise DataError(
                "XpressHuff: stream ended before out_len bytes "
                "(truncated or malformed input)")
        return b""

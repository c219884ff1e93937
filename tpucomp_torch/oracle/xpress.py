"""Plain LZ77 "Xpress" oracle codec — spec-exact [MS-XCA] §2.3–2.4.

Capability parity target: reference ``src/xpress_compress.cpp`` /
``src/xpress_decompress.cpp`` (SURVEY.md §2 row 4; mount unavailable —
grounded in [MS-XCA], SURVEY.md §8.2).

Format summary:

* Stream of 32-bit LE flag words, bits consumed MSB→LSB; 1 = match,
  0 = literal byte.  A fresh flag word is read when 32 flags are exhausted.
  The flag word precedes, in the byte stream, the tokens it describes.
* Match token: u16 LE = ``((offset - 1) << 3) | min(len - 3, 7)``;
  offset ∈ [1, 8192] (13 bits), min length 3.
* Length escape chain when the 3-bit field == 7 ([MS-XCA] §2.4 pseudocode)::

      L = tok & 7
      if L == 7:
          L = nibble()            # shared-nibble state, see below
          if L == 15:
              L = byte()
              if L == 255:
                  L = u16();  if L == 0: L = u32()
                  if L < 15 + 7: error
                  L -= (15 + 7)
              L += 15
          L += 7
      length = L + 3

  The *shared nibble*: the first escape reads a fresh byte at the current
  position and uses its low nibble (remembering the byte's position); the
  second consumes the remembered byte's high nibble; alternating.
* No terminator: the encoder pads the final flag word's unused bits with 1s;
  the decoder stops at the expected output size (which the caller must know).

Worked spec vectors ([MS-XCA] §3.1) are in tests/test_oracle_xpress.py.
"""

from __future__ import annotations

from ..errors import ArgError, DataError

MIN_MATCH = 3
MAX_OFFSET = 8192


def max_compressed_size(n: int) -> int:
    """Worst case: all literals → 1 flag word per 32 bytes + final flag word."""
    return n + 4 * ((n + 31) // 32) + 4


class _Writer:
    """Flag-word + byte-stream writer with shared-nibble escape state."""

    def __init__(self):
        self.out = bytearray()
        self.flags = 0
        self.flag_count = 0
        self.flag_pos = None  # reserved position of current flag word
        self.nibble_pos = -1  # output index of byte holding a pending high nibble

    def _ensure_flag_slot(self):
        if self.flag_pos is None:
            self.flag_pos = len(self.out)
            self.out += b"\x00\x00\x00\x00"

    def put_flag(self, bit: int):
        self._ensure_flag_slot()
        self.flags = ((self.flags << 1) | bit) & 0xFFFFFFFF
        self.flag_count += 1
        if self.flag_count == 32:
            self.out[self.flag_pos : self.flag_pos + 4] = self.flags.to_bytes(
                4, "little"
            )
            self.flags = 0
            self.flag_count = 0
            self.flag_pos = None

    def put_byte(self, b: int):
        self.out.append(b)

    def put_u16(self, v: int):
        self.out += v.to_bytes(2, "little")

    def put_nibble(self, v: int):
        if self.nibble_pos < 0:
            self.nibble_pos = len(self.out)
            self.out.append(v & 0xF)
        else:
            self.out[self.nibble_pos] |= (v & 0xF) << 4
            self.nibble_pos = -1

    def finish(self) -> bytes:
        if self.flag_pos is not None:
            rem = 32 - self.flag_count
            flags = ((self.flags << rem) | ((1 << rem) - 1)) & 0xFFFFFFFF
            self.out[self.flag_pos : self.flag_pos + 4] = flags.to_bytes(
                4, "little"
            )
            self.flag_pos = None
        return bytes(self.out)


def _emit_match(w: _Writer, offset: int, length: int):
    """Emit one match token with the full escape chain of [MS-XCA] §2.3."""
    w.put_flag(1)
    L = length - MIN_MATCH
    w.put_u16(((offset - 1) << 3) | min(L, 7))
    if L >= 7:
        L -= 7
        w.put_nibble(min(L, 15))
        if L >= 15:
            L -= 15
            if L < 255:
                w.put_byte(L)
            else:
                w.put_byte(255)
                # u16 holds length-3 absolutely; 0 escapes to u32.
                full = length - MIN_MATCH
                if full < 0x10000 and full != 0:
                    w.put_u16(full)
                else:
                    w.put_u16(0)
                    w.out += full.to_bytes(4, "little")


def compress(data: bytes, *, window: int = MAX_OFFSET, max_chain: int = 64) -> bytes:
    """Greedy LZ77 encode over the whole buffer (window ≤ 8192 back)."""
    data = bytes(data)
    n = len(data)
    w = _Writer()
    table: dict = {}  # 3-byte prefix -> positions
    pos = 0
    while pos < n:
        best_len = 0
        best_off = 0
        if pos + MIN_MATCH <= n:
            key = data[pos : pos + 3]
            chain = table.get(key, ())
            tried = 0
            for cand in reversed(chain):
                if pos - cand > window:
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
            _emit_match(w, best_off, best_len)
            end = min(pos + best_len, n - 2)
            step = 1 if best_len < 1024 else best_len  # skip interior of huge runs
            for q in range(pos, end, step):
                table.setdefault(data[q : q + 3], []).append(q)
            pos += best_len
        else:
            w.put_flag(0)
            w.put_byte(data[pos])
            if pos + 3 <= n:
                table.setdefault(data[pos : pos + 3], []).append(pos)
            pos += 1
    return w.finish()


class StreamCompressor:
    """Incremental Xpress encoder emitting ONE standard stream.

    Reference ``ms_deflate`` semantics (SURVEY.md §3.5): the match
    window carries across ``compress()`` calls, so matches cross feed
    boundaries and the concatenated output is a single [MS-XCA] §2.3
    stream (decode it one-shot with the total uncompressed size, or
    incrementally with :class:`StreamDecompressor`).

    Output equals one-shot :func:`compress` of the concatenated input,
    except that a match still growable at a feed boundary is committed
    once it reaches ``parse_cap`` (bounds buffering on pathological
    runs; the split match costs a few bytes per ``parse_cap``).
    """

    def __init__(self, *, window: int = MAX_OFFSET, max_chain: int = 64,
                 parse_cap: int = 1 << 20):
        self.window = window
        self.max_chain = max_chain
        self.parse_cap = parse_cap
        self._w = _Writer()
        self._table: dict = {}
        self._data = bytearray()
        self._pos = 0  # parse cursor into _data
        self._emitted = 0  # writer bytes already returned
        self._finished = False
        self.total_in = 0

    def compress(self, chunk: bytes) -> bytes:
        if self._finished:
            raise ArgError("compressor already flushed")
        self._data += bytes(chunk)
        self.total_in += len(chunk)
        self._parse(final=False)
        self._rebase()
        return self._drain()

    def flush(self) -> bytes:
        if self._finished:
            return b""
        self._parse(final=True)
        self._finished = True
        out = self._w.finish()
        res = out[self._emitted :]
        self._emitted = len(out)
        return res

    def _drain(self) -> bytes:
        # only bytes the writer can no longer patch are final: stop at
        # the reserved flag-word slot and a pending shared-nibble byte
        w = self._w
        lim = len(w.out)
        if w.flag_pos is not None:
            lim = min(lim, w.flag_pos)
        if w.nibble_pos >= 0:
            lim = min(lim, w.nibble_pos)
        res = bytes(w.out[self._emitted : lim])
        self._emitted = lim
        return res

    def _parse(self, final: bool):
        data, table, w = self._data, self._table, self._w
        n = len(data)
        pos = self._pos
        while pos < n:
            if not final and pos + MIN_MATCH > n:
                break  # can't tell literal from match start yet
            best_len = 0
            best_off = 0
            hit_end = False  # some candidate's match reaches buffer end
            if pos + MIN_MATCH <= n:
                key = bytes(data[pos : pos + 3])
                chain = table.get(key, ())
                tried = 0
                limit = n - pos
                for cand in reversed(chain):
                    if pos - cand > self.window:
                        break
                    tried += 1
                    if tried > self.max_chain:
                        break
                    length = 0
                    while (
                        length < limit
                        and data[cand + length] == data[pos + length]
                    ):
                        length += 1
                    hit_end = hit_end or length >= limit
                    if length > best_len:
                        best_len = length
                        best_off = pos - cand
                        if length >= limit:
                            break
            if not final and hit_end and n - pos < self.parse_cap:
                break  # a match may still grow with more input
            if best_len >= MIN_MATCH:
                _emit_match(w, best_off, best_len)
                end = min(pos + best_len, n - 2)
                step = 1 if best_len < 1024 else best_len
                for q in range(pos, end, step):
                    table.setdefault(bytes(data[q : q + 3]), []).append(q)
                pos += best_len
            else:
                w.put_flag(0)
                w.put_byte(data[pos])
                if pos + 3 <= n:
                    table.setdefault(bytes(data[pos : pos + 3]), []).append(pos)
                pos += 1
        self._pos = pos

    def _rebase(self):
        """Trim consumed input beyond the window (memory stays
        O(window + unparsed tail), like the reference's ring state)."""
        cut = self._pos - self.window - 8
        if cut < (1 << 20):
            return
        self._table = {
            k: [c - cut for c in ch if c >= cut]
            for k, ch in self._table.items()
            if ch and ch[-1] >= cut
        }
        del self._data[:cut]
        self._pos -= cut


class _NeedMore(Exception):
    """Internal streaming signal: the buffered input ends mid-token."""


class StreamDecompressor:
    """Incremental Xpress decoder taking ARBITRARY byte slices.

    Reference ``ms_inflate`` semantics: feed any slicing of one
    standard stream; decoded bytes are returned as soon as their tokens
    complete.  ``out_len`` is the total uncompressed size (the format
    carries no size header — same contract as one-shot).
    """

    def __init__(self, out_len: int):
        if out_len is None:
            raise ArgError("Xpress: out_len is required")
        self.out_len = out_len
        self._buf = bytearray()
        self._i = 0
        self._flags = 0
        self._flag_count = 0
        self._nibble = -1  # pending high-nibble VALUE (fixed at first read)
        self._win = bytearray()  # last <= MAX_OFFSET output bytes
        self.total_out = 0
        self.total_in = 0

    # -- bounded readers ----------------------------------------------------
    def _take(self, k: int) -> int:
        if self._i + k > len(self._buf):
            raise _NeedMore
        v = int.from_bytes(self._buf[self._i : self._i + k], "little")
        self._i += k
        return v

    def decompress(self, chunk: bytes) -> bytes:
        self._buf += bytes(chunk)
        self.total_in += len(chunk)
        work = self._win
        wbase = len(work)
        while self.total_out < self.out_len:
            snap = (self._i, self._flags, self._flag_count, self._nibble,
                    len(work))
            try:
                self._token(work)
            except _NeedMore:
                (self._i, self._flags, self._flag_count, self._nibble,
                 wlen) = snap
                del work[wlen:]
                break
        produced = bytes(work[wbase:])
        self._win = work[-MAX_OFFSET:]
        del self._buf[: self._i]
        self._i = 0
        return produced

    def _token(self, out: bytearray):
        if self._flag_count == 0:
            self._flags = self._take(4)
            self._flag_count = 32
        is_match = (self._flags >> 31) & 1
        self._flags = (self._flags << 1) & 0xFFFFFFFF
        self._flag_count -= 1
        if not is_match:
            out.append(self._take(1))
            self.total_out += 1
            return
        tok = self._take(2)
        offset = (tok >> 3) + 1
        L = tok & 7
        if L == 7:
            if self._nibble < 0:
                b = self._take(1)
                L = b & 0xF
                self._nibble = b >> 4
            else:
                L = self._nibble
                self._nibble = -1  # snapshot/rollback restores on _NeedMore
            if L == 15:
                L = self._take(1)
                if L == 255:
                    L = self._take(2)
                    if L == 0:
                        L = self._take(4)
                    if L < 15 + 7:
                        raise DataError("Xpress: invalid escape length")
                    L -= 15 + 7
                L += 15
            L += 7
        length = L + MIN_MATCH
        if offset > self.total_out:
            raise DataError("Xpress: match offset before start of output")
        if self.total_out + length > self.out_len:
            raise DataError("Xpress: match overruns expected output size")
        for _ in range(length):
            out.append(out[-offset])
        self.total_out += length

    def flush(self) -> bytes:
        if self.total_out < self.out_len:
            raise DataError("Xpress: stream ended before out_len bytes")
        return b""


def decompress(data: bytes, out_len: int) -> bytes:
    """Decode exactly ``out_len`` bytes ([MS-XCA] §2.4 pseudocode)."""
    if out_len is None:
        raise ArgError("Xpress: out_len is required (format has no size header)")
    data = bytes(data)
    out = bytearray()
    i = 0
    n = len(data)
    flags = 0
    flag_count = 0
    nibble_pos = -1
    while len(out) < out_len:
        if flag_count == 0:
            if i + 4 > n:
                raise DataError("Xpress: truncated flag word")
            flags = int.from_bytes(data[i : i + 4], "little")
            i += 4
            flag_count = 32
        is_match = (flags >> 31) & 1
        flags = (flags << 1) & 0xFFFFFFFF
        flag_count -= 1
        if not is_match:
            if i >= n:
                raise DataError("Xpress: truncated literal")
            out.append(data[i])
            i += 1
        else:
            if i + 2 > n:
                raise DataError("Xpress: truncated match token")
            tok = int.from_bytes(data[i : i + 2], "little")
            i += 2
            offset = (tok >> 3) + 1
            L = tok & 7
            if L == 7:
                if nibble_pos < 0:
                    if i >= n:
                        raise DataError("Xpress: truncated nibble escape")
                    nibble_pos = i
                    L = data[i] & 0xF
                    i += 1
                else:
                    L = data[nibble_pos] >> 4
                    nibble_pos = -1
                if L == 15:
                    if i >= n:
                        raise DataError("Xpress: truncated byte escape")
                    L = data[i]
                    i += 1
                    if L == 255:
                        if i + 2 > n:
                            raise DataError("Xpress: truncated u16 escape")
                        L = int.from_bytes(data[i : i + 2], "little")
                        i += 2
                        if L == 0:
                            if i + 4 > n:
                                raise DataError("Xpress: truncated u32 escape")
                            L = int.from_bytes(data[i : i + 4], "little")
                            i += 4
                        if L < 15 + 7:
                            raise DataError("Xpress: invalid escape length")
                        L -= 15 + 7
                    L += 15
                L += 7
            length = L + MIN_MATCH
            if offset > len(out):
                raise DataError("Xpress: match offset before start of output")
            if len(out) + length > out_len:
                raise DataError("Xpress: match overruns expected output size")
            for _ in range(length):
                out.append(out[-offset])
    return bytes(out)

"""Seeded mutation of valid LZNT1, plain Xpress and Xpress Huffman (XH)
streams, for the differential checks of the decoders.

numpy alone: it imports neither JAX nor tpucomp nor the port, so that
``chip_smoke.py`` may load it by path.  A mutant is rebuilt from
(format, seed, index, operator) by :func:`mutant`: its generator is
``np.random.default_rng((seed, index, OPERATORS[fmt].index(op)))``, which
picks the source stream, the donor of a splice and every position and
value.

Operators of every format:

* ``flip_bits``: flip 1-4 random bits;
* ``set_byte``: set a byte to 0x00, 0xFF or a random value;
* ``truncate``: cut at a random length, 0, 1 or a header alone (2 bytes
  of LZNT1, 4 of Xpress, the 256-byte table of XH);
* ``extend``: append 1-64 random bytes;
* ``splice``: overwrite a span with a span of another valid stream of
  the format.

LZNT1: ``header_size`` (a chunk header's size field moved by 1 to 16
either way), ``header_comp`` (its compressed bit toggled),
``header_sig`` (its signature bits 12-14 changed), ``end_mark`` (a
0x0000 header put between two chunks).

Plain Xpress: ``flag_word`` (1-8 bits of a flag word flipped),
``u32_escape`` (a match given the u32 length escape: its length bits
and nibble 7 and 0xF, then 0xFF, 0x0000 and a u32 length inserted where
the decoder reads them: its own length, 0, 21, 22, 2^31 - 3, 2^32 - 1
or a random one), ``out_len`` (the decoded length moved by 1 either
way, to 0, or past the content).

XH: ``table_nibbles`` (1-8 code lengths of the 256-byte table set to
random values), ``kraft_over`` (unused symbols given short codes: more
codes than the Kraft sum allows), ``kraft_under`` (codes dropped or
lengthened: fewer than it needs), ``table_zero`` (an all-zero table),
``escape15`` (a length-header-15 match's escape re-encoded in place with
another form or value: byte, 0xFF + u16, 0xFF + 0x0000 + u32),
``out_len`` (as plain Xpress), ``block_edge`` (1-4 bytes changed within
16 bytes either side of a block's table; block 0's table where the
stream has one block).

A format operator that finds nothing to act on (a stream with no
u32-capable match, no length-15 match) falls back to ``flip_bits`` on
its own generator.  Format-aware positions come from a parse of the
source stream (:func:`xpress_tokens`, :func:`xh_tokens`), cached by
source and cut at ``PARSE_LIMIT`` input bytes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

GENERIC = ("flip_bits", "set_byte", "truncate", "extend", "splice")
OPERATORS = {
    "lznt1": GENERIC + ("header_size", "header_comp", "header_sig",
                        "end_mark"),
    "xpress": GENERIC + ("flag_word", "u32_escape", "out_len"),
    "xpress_huff": GENERIC + ("table_nibbles", "kraft_over", "kraft_under",
                              "table_zero", "escape15", "out_len",
                              "block_edge"),
}
HEADER = {"lznt1": 2, "xpress": 4, "xpress_huff": 256}
PARSE_LIMIT = 16384  # input bytes a format-aware operator looks into
XH_BLOCK = 65536


class Mutant(NamedTuple):
    stream: bytes
    out_len: int  # for LZNT1 the source's decoded length, informative
    op: str
    seed: int
    index: int


def mutant(fmt: str, sources, seed: int, index: int, op: str,
           out_cap: int | None = None, source: int | None = None) -> Mutant:
    """Mutant ``index`` of ``seed`` under ``op``: ``sources`` is a list of
    (stream, out_len) valid streams of ``fmt``; ``out_cap`` bounds a
    mutated out_len (the unit width of a batch decode); ``source``, where
    given, is the stream mutated (else the generator picks one)."""
    rng = np.random.default_rng((seed, index, OPERATORS[fmt].index(op)))
    k = int(rng.integers(len(sources)))
    k = k if source is None else source
    stream, out_len = sources[k]
    d = int(rng.integers(len(sources)))
    s, n = _apply(fmt, op, bytes(stream), int(out_len), rng,
                  bytes(sources[d][0]), out_cap)
    return Mutant(s, n, op, seed, index)


def mutants(fmt: str, sources, count: int, seed: int, ops=None,
            out_cap: int | None = None) -> list:
    """``count`` mutants, indices 0 on, the operators taken in turn from
    ``ops`` (default: all of the format's)."""
    ops = tuple(ops or OPERATORS[fmt])
    return [mutant(fmt, sources, seed, i, ops[i % len(ops)], out_cap)
            for i in range(count)]


# ---- the operators ----------------------------------------------------------

def _apply(fmt, op, s, n, rng, donor, out_cap):
    b = bytearray(s)
    if op == "flip_bits":
        return _flip_bits(b, rng), n
    if op == "set_byte":
        if not b:
            return bytes([int(rng.integers(256))]), n
        i = int(rng.integers(len(b)))
        b[i] = int(rng.choice([0x00, 0xFF, int(rng.integers(256))]))
        return bytes(b), n
    if op == "truncate":
        cut = int(rng.choice([0, 1, HEADER[fmt], int(rng.integers(len(b) + 1)),
                              int(rng.integers(len(b) + 1))]))
        return bytes(b[:min(cut, len(b))]), n
    if op == "extend":
        extra = rng.integers(0, 256, int(rng.integers(1, 65)), np.uint8)
        return bytes(b) + extra.tobytes(), n
    if op == "splice":
        if not b or not donor:
            return _flip_bits(b, rng), n
        w = int(rng.integers(1, min(256, len(donor)) + 1))
        src = int(rng.integers(len(donor) - w + 1))
        dst = int(rng.integers(len(b)))
        b[dst:dst + w] = donor[src:src + w]
        return bytes(b), n
    if op == "out_len":
        return bytes(b), _out_len(n, rng, out_cap)
    return {"lznt1": _lznt1, "xpress": _xpress,
            "xpress_huff": _xh}[fmt](op, b, n, rng)


def _flip_bits(b: bytearray, rng) -> bytes:
    if not b:
        return b""
    for _ in range(int(rng.integers(1, 5))):
        i = int(rng.integers(len(b) * 8))
        b[i >> 3] ^= 1 << (i & 7)
    return bytes(b)


def _out_len(n: int, rng, out_cap) -> int:
    cap = out_cap if out_cap is not None else n + 4096
    choice = int(rng.integers(4))
    if choice == 0:
        n2 = n + 1
    elif choice == 1:
        n2 = n - 1
    elif choice == 2:
        n2 = 0
    else:
        n2 = n + int(rng.integers(1, 4097))
    return max(0, min(n2, cap))


# ---- LZNT1 ------------------------------------------------------------------

def lznt1_chunks(s: bytes) -> list:
    """(start, end) of every chunk, header included, up to a 0x0000 header,
    the end, or a chunk that runs past the end."""
    spans, i = [], 0
    while i + 2 <= len(s):
        header = s[i] | (s[i + 1] << 8)
        if header == 0:
            break
        end = i + 2 + (header & 0xFFF) + 1
        if end > len(s):
            break
        spans.append((i, end))
        i = end
    return spans


def lznt1_walk(s: bytes) -> dict:
    """Walk an LZNT1 stream as the oracle decodes it ([MS-XCA] §2.5),
    counting output positions only.  Returns ``error`` (why the oracle
    stops, or None) and the feature ``past_4096``: a compressed chunk
    holds a token that starts once its output already holds 4096 bytes
    (the device parse stops at 4096 and ignores it)."""
    w = {"error": None, "past_4096": False}
    i = 0
    while i + 2 <= len(s):
        header = s[i] | (s[i + 1] << 8)
        i += 2
        if header == 0:
            break
        size = (header & 0xFFF) + 1
        if i + size > len(s):
            w["error"] = "chunk past the end"
            return w
        end, p = i + size, 0
        if not header & 0x8000:
            i = end
            continue
        while i < end:
            flags = s[i]
            i += 1
            for bit in range(8):
                if i >= end:
                    break
                w["past_4096"] |= p >= 4096
                if not flags >> bit & 1:
                    i, p = i + 1, p + 1
                    continue
                if i + 2 > end:
                    w["error"] = "cut copy token"
                    return w
                tok = s[i] | (s[i + 1] << 8)
                i += 2
                q, shift = max(p - 1, 0), 12
                while q >= 0x10:
                    q >>= 1
                    shift -= 1
                length = (tok & ((1 << shift) - 1)) + 3
                if (tok >> shift) + 1 > p:
                    w["error"] = "copy before the chunk"
                    return w
                p += length
            if p > 4096:
                w["error"] = "chunk past 4096 bytes"
                return w
    return w


def _lznt1(op, b, n, rng):
    spans = lznt1_chunks(bytes(b))
    if not spans:
        return _flip_bits(b, rng), n
    a, e = spans[int(rng.integers(len(spans)))]
    header = b[a] | (b[a + 1] << 8)
    if op == "header_size":
        delta = int(rng.integers(1, 17)) * int(rng.choice([-1, 1]))
        size = min(max((header & 0xFFF) + delta, 0), 0xFFF)
        header = (header & 0xF000) | size
    elif op == "header_comp":
        header ^= 0x8000
    elif op == "header_sig":
        sig = (header >> 12) & 7
        new = int(rng.choice([v for v in range(8) if v != sig]))
        header = (header & 0x8FFF) | (new << 12)
    else:  # end_mark: between two chunks, never after the last
        if len(spans) < 2:
            return _flip_bits(b, rng), n
        at = spans[int(rng.integers(len(spans) - 1))][1]
        return bytes(b[:at]) + b"\x00\x00" + bytes(b[at:]), n
    b[a], b[a + 1] = header & 0xFF, header >> 8
    return bytes(b), n


# ---- plain Xpress -----------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def xpress_tokens(s: bytes, limit: int = PARSE_LIMIT):
    """Walk a plain Xpress stream ([MS-XCA] §2.4.4) up to ``limit`` input
    bytes.  Returns (flag word offsets, matches): each match (token
    offset, nibble byte offset, nibble half (0 low, 1 high), escape
    offset, escape bytes, length) for the matches whose length bits are
    7; a match whose nibble is 0xF carries its escape bytes.  Stops
    quietly at a malformed or cut token.  Cached: the operators parse
    each source once."""
    flags_at, matches = [], []
    i, n, count, flags, nib = 0, min(len(s), limit), 0, 0, -1
    while i < n:
        if count == 0:
            if i + 4 > n:
                break
            flags_at.append(i)
            flags = int.from_bytes(s[i:i + 4], "little")
            i, count = i + 4, 32
        count -= 1
        if not (flags >> count) & 1:
            i += 1
            continue
        if i + 2 > n:
            break
        tok = s[i] | (s[i + 1] << 8)
        t, i = i, i + 2
        L = tok & 7
        if L != 7:
            continue
        if nib < 0:
            if i >= n:
                break
            nib_at, half, nib, i = i, 0, i, i + 1
            L = s[nib_at] & 0xF
        else:
            nib_at, half, nib = nib, 1, -1
            L = s[nib_at] >> 4
        esc, esc_n = i, 0
        if L == 15:
            if i >= n:
                break
            L, esc_n = s[i], 1
            if L == 255:
                if i + 3 > n:
                    break
                L, esc_n = s[i + 1] | (s[i + 2] << 8), 3
                if L == 0:
                    if i + 7 > n:
                        break
                    L, esc_n = int.from_bytes(s[i + 3:i + 7], "little"), 7
                L -= 22
            L += 15
        i += esc_n
        matches.append((t, nib_at, half, esc, esc_n, L + 10))
    return flags_at, matches


def xpress_walk(s: bytes) -> dict:
    """The feature of a plain Xpress stream that explains a disagreement
    between the decoders: ``wrap``, a match whose length escape gives a
    length of 2^31 or more (int32 wraps on the device and in the native
    C)."""
    _, matches = xpress_tokens(s, limit=len(s))
    return {"wrap": any(m[5] >= 2 ** 31 for m in matches)}


def _xpress(op, b, n, rng):
    flags_at, matches = xpress_tokens(bytes(b))
    if op == "flag_word":
        if not flags_at:
            return _flip_bits(b, rng), n
        at = flags_at[int(rng.integers(len(flags_at)))]
        for _ in range(int(rng.integers(1, 9))):
            bit = int(rng.integers(32))
            b[at + (bit >> 3)] ^= 1 << (bit & 7)
        return bytes(b), n
    # u32_escape
    if not matches:
        return _flip_bits(b, rng), n
    t, nib_at, half, esc, esc_n, length = matches[
        int(rng.integers(len(matches)))]
    b[nib_at] = (b[nib_at] | 0x0F) if half == 0 else (b[nib_at] | 0xF0)
    value = int(rng.choice([length - 3, 0, 21, 22, 2 ** 31 - 3, 2 ** 32 - 1,
                            int(rng.integers(2 ** 32))]))
    value = max(value, 0)
    new = b"\xff\x00\x00" + value.to_bytes(4, "little")
    return bytes(b[:esc]) + new + bytes(b[esc + esc_n:]), n


# ---- Xpress Huffman ---------------------------------------------------------

def _decode_table(lengths):
    """Canonical code of 512 lengths as a 15-bit peek table: each entry
    sym << 4 | length, -1 where no code; None if the code is
    over-subscribed."""
    lengths = np.asarray(lengths, np.int64)
    used = np.flatnonzero(lengths)
    if not used.size:
        return None
    kraft = int((1 << (15 - lengths[used])).sum())
    if kraft > 1 << 15:
        return None
    order = used[np.lexsort((used, lengths[used]))]
    table = np.full(1 << 15, -1, np.int64)
    code, prev = 0, int(lengths[order[0]])
    for sym in order:
        ln = int(lengths[sym])
        code <<= ln - prev
        prev = ln
        span = 1 << (15 - ln)
        table[code * span:(code + 1) * span] = (int(sym) << 4) | ln
        code += 1
    return table


@functools.lru_cache(maxsize=4096)
def xh_tokens(s: bytes, out_len: int, limit: int = PARSE_LIMIT):
    """Block table offsets and length-header-15 escapes of an XH stream,
    for the operators: :func:`xh_walk` cut at ``limit`` input bytes of a
    one-block stream, cached.  Returns (blocks, escapes)."""
    w = xh_walk(s, out_len, limit if out_len <= XH_BLOCK else None)
    return w["blocks"], w["escapes"]


def xh_walk(s: bytes, out_len: int, limit: int | None = None) -> dict:
    """Walk an XH stream as the oracle decodes it ([MS-XCA] §2.2.4 with
    the repo's order: a match's offset bits before its length escape;
    reads past the end give zeros), counting output bytes only.

    Returns ``blocks`` (each block's table offset), ``escapes`` (offset,
    bytes, length of each length-header-15 match), ``error`` (why the
    oracle stops, or None), and the features that explain a disagreement
    between the decoders: ``oversubscribed`` (a block's code lengths
    over-subscribe the Kraft sum), ``past_end`` (the walk takes a bit or
    an escape byte past the end of the input), ``wrap`` (an escape length
    of 2^31 - 3 or more, which wraps int32).  ``limit`` stops the walk
    after that many input bytes of a block (``error`` "limit")."""
    w = {"blocks": [], "escapes": [], "error": None, "oversubscribed": False,
         "past_end": False, "wrap": False}
    pos, done = 0, 0
    while done < out_len:
        if pos + 256 > len(s):
            w["error"] = "truncated table"
            return w
        w["blocks"].append(pos)
        tb = np.frombuffer(s[pos:pos + 256], np.uint8)
        lengths = np.empty(512, np.int64)
        lengths[0::2], lengths[1::2] = tb & 0xF, tb >> 4
        if not lengths.any():
            w["error"] = "empty table"
            return w
        table = _decode_table(lengths)
        if table is None:
            w["oversubscribed"] = True
            w["error"] = "over-subscribed table"
            return w
        r = _Bits(s, pos + 256)
        end = min(done + XH_BLOCK, out_len)
        while done < end:
            if limit is not None and r.pos - pos > limit:
                w["error"] = "limit"
                return w
            entry = int(table[r.peek15()])
            if entry < 0:
                w["error"] = "invalid code"
                return w
            r.skip(entry & 0xF)
            sym = entry >> 4
            if sym < 256:
                done += 1
                continue
            obc, L = (sym - 256) >> 4, (sym - 256) & 0xF
            offset = (1 << obc) | (r.peek_bits(obc) if obc else 0)
            r.skip(obc)
            if L == 15:
                at = r.pos
                L = r.byte()
                esc_n = 1
                if L == 255:
                    L = r.u16()
                    esc_n = 3
                    if L == 0:
                        L = r.u16() | (r.u16() << 16)
                        esc_n = 7
                else:
                    L += 15
                w["past_end"] |= at + esc_n > len(s)
                w["escapes"].append((at, esc_n, L + 3))
                w["wrap"] |= L + 3 >= 2 ** 31
            if offset > done:
                w["error"] = "offset before the output"
                return w
            if done + L + 3 > out_len:
                w["error"] = "match past out_len"
                return w
            done += L + 3
        flushes = max(0, -(-r.bits // 16) - 1)
        nxt = pos + 256 + 2 * (2 + flushes) + r.raw
        w["past_end"] |= nxt > len(s)
        pos = nxt
    return w


class _Bits:
    """The XH bit reader: a 32-bit window of 16-bit little-endian words,
    refilled when fewer than 16 bits remain; raw bytes read between
    words.  Reads past the end give zeros."""

    def __init__(self, s, pos):
        self.s, self.pos, self.bits, self.raw = s, pos, 0, 0
        self.buf = (self._w() << 16) | self._w()
        self.count = 32

    def _w(self):
        s, p = self.s, self.pos
        self.pos += 2
        return (s[p] if p < len(s) else 0) | \
            ((s[p + 1] if p + 1 < len(s) else 0) << 8)

    def peek15(self):
        return self.buf >> 17

    def peek_bits(self, k):
        return self.buf >> (32 - k)

    def skip(self, k):
        if not k:
            return
        self.buf = (self.buf << k) & 0xFFFFFFFF
        self.count -= k
        self.bits += k
        if self.count < 16:
            self.buf |= self._w() << (16 - self.count)
            self.count += 16

    def byte(self):
        v = self.s[self.pos] if self.pos < len(self.s) else 0
        self.pos += 1
        self.raw += 1
        return v

    def u16(self):
        self.raw += 2
        return self._w()


def _xh(op, b, n, rng):
    blocks, escapes = xh_tokens(bytes(b), n)
    if not blocks:
        return _flip_bits(b, rng), n
    t = blocks[int(rng.integers(len(blocks)))]
    if op in ("table_nibbles", "kraft_over", "kraft_under", "table_zero"):
        tb = np.frombuffer(bytes(b[t:t + 256]), np.uint8)
        lengths = np.empty(512, np.int64)
        lengths[0::2], lengths[1::2] = tb & 0xF, tb >> 4
        used = np.flatnonzero(lengths)
        free = np.flatnonzero(lengths == 0)
        k = int(rng.integers(1, 9))
        if op == "table_nibbles":
            syms = rng.integers(0, 512, k)
            lengths[syms] = rng.integers(0, 16, k)
        elif op == "kraft_over":
            pool = free if free.size else np.arange(512)
            syms = rng.choice(pool, min(k, pool.size), replace=False)
            short = max(1, int(lengths[used].min()) if used.size else 1)
            lengths[syms] = short
        elif op == "kraft_under":
            if used.size:
                syms = rng.choice(used, min(k, used.size), replace=False)
                if rng.integers(2):
                    lengths[syms] = 0
                else:
                    lengths[syms] = np.minimum(lengths[syms] + 1, 15)
        else:
            lengths[:] = 0
        b[t:t + 256] = (lengths[0::2] | (lengths[1::2] << 4)).astype(
            np.uint8).tobytes()
        return bytes(b), n
    if op == "block_edge":
        for _ in range(int(rng.integers(1, 5))):
            i = t + int(rng.integers(-16, 16))
            if 0 <= i < len(b):
                b[i] = int(rng.integers(256))
        return bytes(b), n
    # escape15
    if not escapes:
        return _flip_bits(b, rng), n
    at, esc_n, length = escapes[int(rng.integers(len(escapes)))]
    L = length - 3  # the value the escape codes (as the decoders read it)
    form = int(rng.integers(3))
    value = int(rng.choice([L, 0, 14, 15, 2 ** 31 - 3, 2 ** 32 - 1,
                            int(rng.integers(2 ** 32))]))
    if form == 0 and 15 <= value < 15 + 255:
        new = bytes([value - 15])
    elif form == 1 and value < 1 << 16:
        new = b"\xff" + value.to_bytes(2, "little")
    else:
        new = b"\xff\x00\x00" + (value % (1 << 32)).to_bytes(4, "little")
    return bytes(b[:at]) + new + bytes(b[at + esc_n:]), n


# ---- the classes of disagreement between the decoders -----------------------

UNLISTED = "unlisted"
# name -> (format, the sides' behaviour); ROADMAP.md queue 3 has each with
# its pinned case and the [MS-XCA] ruling
CLASSES = {
    "lznt1-tokens-past-4096": (
        "lznt1", "a compressed chunk holds tokens after its output reached "
        "4096 bytes: the device ignores them and accepts, the native C "
        "and the oracle reject"),
    "xpress-u32-escape-wrap": (
        "xpress", "a u32 length escape gives a length of 2^31 or more: "
        "int32 wraps on the device and in the native C"),
    "xpress-unit-past-capacity": (
        "xpress", "a unit stream longer than a unit's largest encoding "
        "(max_payload of the unit size): the device path refuses it "
        "(tpucomp with numpy's ValueError, the port with DataError), the "
        "native C and the oracle decode its first out_len bytes"),
    "xh-u32-escape-wrap": (
        "xpress_huff", "a u32 length escape gives a length of 2^31 or "
        "more: int32 wraps on the device and in the native C"),
    "xh-oversubscribed-table": (
        "xpress_huff", "a block's code lengths over-subscribe the Kraft "
        "sum: the device decodes with them, the native C and the oracle "
        "reject"),
    "xh-reads-past-end": (
        "xpress_huff", "the decode needs bits or escape bytes past the end "
        "of the input: the device rejects, the oracle reads zeros, the "
        "native C reads zero bits and u16 escapes but rejects an escape "
        "byte or u32 past the end"),
}


def _rejects(out) -> bool:
    return out[0] != "ok"


def xpress_max_payload(unit_size: int) -> int:
    """The longest plain Xpress stream a unit of ``unit_size`` bytes
    encodes to, the width of the device path's rows (the port's
    ``codecs.xpress.max_payload``)."""
    return unit_size + 4 * ((unit_size + 31) // 32) + 8


def classify(fmt: str, stream: bytes, out_len, outcomes: dict,
             unit_size: int | None = None) -> list:
    """The classes that explain a disagreement among ``outcomes`` (side
    name -> ("ok", bytes) or (exception class name,); the sides
    ``"device"``, ``"native"``, ``"oracle"``, any with ``"device"``): []
    where they all agree, [UNLISTED] where no class of ``fmt`` does.
    ``unit_size`` is the unit width of the device path's batch, where
    the device outcome came from one."""
    vals = list(outcomes.values())
    if all(v == vals[0] for v in vals):
        return []
    dev = outcomes["device"]
    hosts = [v for k, v in outcomes.items() if k != "device"]
    found = []
    if fmt == "lznt1":
        w = lznt1_walk(stream)
        if w["past_4096"] and not _rejects(dev) and \
                all(_rejects(h) for h in hosts):
            found.append("lznt1-tokens-past-4096")
    elif fmt == "xpress":
        if xpress_walk(stream)["wrap"]:
            found.append("xpress-u32-escape-wrap")
        if unit_size is not None and _rejects(dev) and \
                len(stream) > xpress_max_payload(unit_size):
            found.append("xpress-unit-past-capacity")
    else:
        w = xh_walk(stream, out_len)
        if w["wrap"]:
            found.append("xh-u32-escape-wrap")
        if w["oversubscribed"] and all(_rejects(h) for h in hosts):
            found.append("xh-oversubscribed-table")
        if w["past_end"] and _rejects(dev):
            found.append("xh-reads-past-end")
    return found or [UNLISTED]

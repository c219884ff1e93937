"""Seeded data of the benchmark's deployments, made with vectorised NumPy.

A configuration's ``mix`` names the kinds of data a page holds and the
share of pages of each kind.  Every seed gets the same pages of each
kind, in runs of the same lengths: the seed changes the order of the
runs and the bytes inside them, not how much of each kind there is, so
the work of a call hardly moves from seed to seed.  For the same reason
each kind's dictionary (the text's vocabulary, the code's instruction
templates, the records' sources, the heap's bases) is fixed, the same
for every seed: the seed draws the sequence, not the dictionary.

Kinds:

* ``zero``: zero bytes.
* ``runs``: runs of a fill byte (0x00 most, then 0xFF, 0x20, 0xCC) of
  64 to 8192 bytes, with a few random bytes between them.
* ``text``: log and text lines: words of a Zipf-distributed vocabulary,
  separated by spaces and newlines.
* ``records``: 32-byte little-endian records: a sequence number, a time
  stamp with small deltas, a type, a length, a source, a running offset
  and a random check word.
* ``code``: executable-like bytes: instructions drawn by Zipf from a
  table of templates, some ending in a 32-bit displacement.
* ``heap``: 8-byte words: pointers near a few bases, small integers,
  zeros and random words.
* ``random``: uniform random bytes (already compressed data).
"""

from __future__ import annotations

import numpy as np


def rng_for(*keys: int) -> np.random.Generator:
    """A generator seeded by whole numbers of any size and sign."""
    return np.random.default_rng(
        np.random.SeedSequence([int(k) & (2**64 - 1) for k in keys]))


def _ragged(table: np.ndarray, lens: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """The concatenation of pieces ``ids``: piece i is the first
    ``lens[i]`` bytes of row i of the uint8 ``table``."""
    return table[ids][np.arange(table.shape[1]) < lens[ids][:, None]]


def _pieces(lens: np.ndarray, fill) -> np.ndarray:
    """A zeroed uint8 table with a row per piece, as wide as the longest,
    whose first ``lens[i]`` bytes of row i are drawn by ``fill(count)``."""
    table = np.zeros((len(lens), int(lens.max())), np.uint8)
    mask = np.arange(table.shape[1]) < lens[:, None]
    table[mask] = fill(int(mask.sum()))
    return table


def _dictionary(kind: str) -> np.random.Generator:
    """The fixed generator of a kind's dictionary."""
    return rng_for(0x0D1C7, sorted(KINDS).index(kind))


def _zipf_ids(rng, n: int, vocab: int, a: float) -> np.ndarray:
    """``n`` draws of 0..vocab-1, id k with weight (k + 1) ** -a."""
    cdf = np.cumsum(np.arange(1, vocab + 1, dtype=np.float64) ** -a)
    return np.searchsorted(cdf, rng.random(n) * cdf[-1], side="right")


def _zero(rng, n):
    return np.zeros(n, np.uint8)


def _random(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8)


def _runs(rng, n):
    k = n // 64 // 64 + 2
    lens = rng.integers(64, 8193, k)
    lens[-1] = n
    vals = rng.choice(np.array([0x00, 0xFF, 0x20, 0xCC], np.uint8), k,
                      p=[0.7, 0.1, 0.1, 0.1])
    out = np.repeat(vals, lens)[:n]
    noisy = rng.random(n) < 0.002
    out[noisy] = rng.integers(0, 256, int(noisy.sum()), dtype=np.uint8)
    return out


def _text(rng, n):
    vocab = 4096
    d = _dictionary("text")
    wlen = d.integers(2, 10, vocab)
    words = _pieces(wlen, lambda k: d.integers(ord("a"), ord("z") + 1, k,
                                               dtype=np.uint8))
    words[d.random(vocab) < 0.1, 0] -= 32
    # a word and the space or newline after it
    table = np.zeros((2 * vocab, words.shape[1] + 1), np.uint8)
    table[:vocab, :-1] = table[vocab:, :-1] = words
    table[np.arange(2 * vocab), np.tile(wlen, 2)] = np.repeat(
        np.array([32, 10], np.uint8), vocab)
    ids = (_zipf_ids(rng, n // 5 + 16, vocab, 1.3)
           + vocab * (rng.random(n // 5 + 16) < 1 / 12))
    out = _ragged(table, np.tile(wlen + 1, 2), ids)
    while len(out) < n:
        out = np.concatenate([out, out])
    return out[:n]


def _records(rng, n):
    k = n // 32 + 1
    rec = np.zeros(k, [("seq", "<u4"), ("time", "<u4"), ("type", "<u2"),
                       ("len", "<u2"), ("src", "<u4"), ("off", "<u8"),
                       ("check", "<u4"), ("pad", "<u4")])
    rec["seq"] = rng.integers(0, 2**31) + np.arange(k)
    rec["time"] = rng.integers(0, 2**31) + np.cumsum(rng.geometric(0.3, k))
    rec["type"] = _zipf_ids(rng, k, 12, 1.5)
    rec["len"] = rng.integers(0, 1500, k)
    rec["src"] = _dictionary("records").integers(
        0, 2**32, 64, dtype=np.uint64)[rng.integers(0, 64, k)]
    rec["off"] = np.cumsum(rec["len"].astype(np.uint64))
    rec["check"] = rng.integers(0, 2**32, k, dtype=np.uint64)
    return np.frombuffer(rec.tobytes(), np.uint8)[:n]


def _code(rng, n):
    ntpl = 512
    d = _dictionary("code")
    tlen = d.integers(1, 8, ntpl)
    # templates with a displacement have 4 more bytes, filled per instance
    disp = d.random(ntpl) < 0.3
    dlen = tlen + 4 * disp
    table = _pieces(tlen, lambda k: d.integers(0, 256, k, dtype=np.uint8))
    table = np.pad(table, ((0, 0), (0, 4)))
    # first bytes from a skewed opcode set, the rest ModRM/SIB-like
    ops = d.integers(0, 256, 48, dtype=np.uint8)
    table[:, 0] = ops[_zipf_ids(d, ntpl, 48, 1.4)]
    ids = _zipf_ids(rng, n // 3 + 16, ntpl, 1.2)
    out = _ragged(table, dlen, ids)
    with_disp = np.cumsum(dlen[ids])[disp[ids]]
    vals = rng.integers(-65536, 65536, len(with_disp)).astype("<i4")
    out[with_disp[:, None] - 4 + np.arange(4)] = np.frombuffer(
        vals.tobytes(), np.uint8).reshape(-1, 4)
    while len(out) < n:
        out = np.concatenate([out, out])
    return out[:n]


def _heap(rng, n):
    k = n // 8 + 1
    bases = (0x00007FF000000000 + _dictionary("heap").integers(
        0, 2**28, 8, dtype=np.uint64) * 4096)
    kind = rng.choice(4, k, p=[0.45, 0.30, 0.15, 0.10])
    words = np.zeros(k, np.uint64)
    ptr = kind == 0
    words[ptr] = (bases[rng.integers(0, 8, int(ptr.sum()))]
                  + rng.integers(0, 2**16, int(ptr.sum()), dtype=np.uint64)
                  * 16)
    small = kind == 1
    words[small] = rng.integers(0, 65536, int(small.sum()), dtype=np.uint64)
    rnd = kind == 3
    words[rnd] = rng.integers(0, 2**63, int(rnd.sum()), dtype=np.uint64)
    return np.frombuffer(words.astype("<u8").tobytes(), np.uint8)[:n]


KINDS = {"zero": _zero, "runs": _runs, "text": _text, "records": _records,
         "code": _code, "heap": _heap, "random": _random}


def page_kinds(mix: dict, pages: int, rng) -> np.ndarray:
    """The kind of each of ``pages`` pages, as indices into
    ``sorted(mix["shares"])``: each kind's share of the pages (rounded,
    the remainder to the largest share), in runs of 1, 2, ...,
    ``mix["max_run"]`` pages cut from its count in that order, the runs
    of all kinds shuffled by ``rng``."""
    names = sorted(mix["shares"])
    counts = np.array([int(round(mix["shares"][k] * pages)) for k in names])
    counts[int(np.argmax([mix["shares"][k] for k in names]))] += (
        pages - counts.sum())
    runs = []
    for kind, count in enumerate(counts):
        length = 0
        while count > 0:
            length = length % mix["max_run"] + 1
            take = min(length, count)
            runs.append((kind, take))
            count -= take
    order = rng.permutation(len(runs))
    return np.concatenate([np.full(runs[i][1], runs[i][0]) for i in order])


def make(mix: dict, nbytes: int, rng) -> np.ndarray:
    """``nbytes`` (a multiple of ``mix["page"]``) of data of ``mix``."""
    page = mix["page"]
    pages = nbytes // page
    kinds = page_kinds(mix, pages, rng)
    out = np.empty((pages, page), np.uint8)
    for i, name in enumerate(sorted(mix["shares"])):
        rows = np.nonzero(kinds == i)[0]
        if len(rows):
            out[rows] = KINDS[name](rng, len(rows) * page).reshape(-1, page)
    return out.reshape(-1)


def unit_lengths(units: dict, rng) -> np.ndarray:
    """Byte lengths of a call's units: ``units["count"]`` units of
    ``units["bytes"]``, except that ``units["short"]`` lists the lengths
    of some, whose places ``rng`` draws."""
    lens = np.full(units["count"], units["bytes"], np.int64)
    short = units.get("short", [])
    lens[rng.choice(units["count"], len(short), replace=False)] = short
    return lens

"""The one-shot Xpress Huffman decode's malformed streams and its
history decode's parts on the CPU, against tpucomp: each malformed
stream raises ``DataError`` where tpucomp's ``decompress`` does, after
as many batch decodes; the history decode's err, span and bytes, and the
parse's err and span, against tpucomp's scan with a history
(``_decode_impl(..., want_span=True, hist, hist_len)``); the resolve of
``[history | block]`` rows of 131072 against tpucomp's.  Every value is
a byte or an integer: the tolerance is exact equality.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_xh_oneshot import BLOCK, _data, _hold, _stream
from tpucomp import _native
from tpucomp.codecs import xpress_huff as t_xh
from tpucomp.kernels import common as t_common
from tpucomp_torch.codecs import xpress_huff as xh
from tpucomp_torch.kernels import common, fill, resolve
from _threads import _one_thread  # noqa: F401


def _periodic():
    """Two and a half blocks that compress to a few hundred bytes: the
    source of the malformed streams."""
    data = (b"abcabd" * 30000)[:2 * BLOCK + 30000]
    return data, _native.xh_compress(data)


def _malformed(kind):
    data, s = _periodic()
    n = len(data)
    if kind == "cut_short":
        return s[:len(s) // 2], n
    if kind == "flipped":  # bits of the second block's body
        b = bytearray(s)
        second = len(_native.xh_compress(data[:BLOCK]))
        for k in (second + 260, second + 263):
            b[k] ^= 0x5A
        return bytes(b), n
    if kind == "random_table":
        r = np.random.default_rng(5)
        return r.integers(0, 256, 256, dtype=np.uint8).tobytes() + s[256:], n
    if kind == "out_len_past_end":
        return s, n + 5000
    if kind == "shorter_than_table":
        return s[:200], 100
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["cut_short", "flipped", "random_table",
                                  "out_len_past_end", "shorter_than_table"])
def test_malformed_streams_raise_as_tpucomp(kind):
    stream, n = _malformed(kind)
    _hold(stream, n)


# ---- the history decode's parts ---------------------------------------------


@functools.lru_cache(maxsize=None)
def _history_rows():
    """Rows of the history decode: the first three blocks of the
    cross-block stream and of the native ten-block stream, sliced as the speculative batch
    slices them (the bytes of the blocks after it follow), at several
    history reaches: the full 64 KiB, none (the cross-block stream's
    later blocks reach before their start: err) and the true output
    before the block (at most 64 KiB).  Returns numpy (payload, plen, out_len,
    ss, hist, hist_len) at the batch's substep tier."""
    rows = []
    for name in ("cross_block", "ten_blocks"):
        s, data = _stream(name), _data(name)
        # the candidates of these two streams are their block starts
        starts = t_xh._kraft_candidates(np.frombuffer(s, np.uint8))
        assert len(starts) == -(-len(data) // BLOCK)
        for k, o in enumerate(starts[:3].tolist()):
            olen = min(BLOCK, len(data) - k * BLOCK)
            before = data[max(0, k * BLOCK - BLOCK):k * BLOCK]
            for hlen, hist in ((BLOCK, b""), (0, b""),
                               (len(before), before)):
                rows.append((s[o:o + 8000], olen, hist, hlen))
    N = len(rows)
    P = 8000 + 16
    payload = np.zeros((N, P), np.int32)
    hist = np.zeros((N, BLOCK), np.int32)
    plen, olen, hl = (np.zeros(N, np.int32) for _ in range(3))
    for i, (sl, n, h, hlen) in enumerate(rows):
        payload[i, :len(sl)] = np.frombuffer(sl, np.uint8)
        plen[i], olen[i], hl[i] = len(sl), n, hlen
        if h:
            hist[i, BLOCK - len(h):] = np.frombuffer(h, np.uint8)
    ss = max(xh._substeps_for(xh._min_code_len([bytes(
        payload[i, :256].astype(np.uint8))])) for i in range(N))
    return payload, plen, olen, np.full(N, ss, np.int32), hist, hl


@functools.lru_cache(maxsize=None)
def _tpucomp_history_decode():
    payload, plen, olen, ss, hist, hl = _history_rows()
    return tuple(np.asarray(a) for a in t_xh._decode_impl(
        jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(olen), BLOCK,
        int(ss[0]), want_span=True, hist=jnp.asarray(hist),
        hist_len=jnp.asarray(hl)))


def test_history_decode_matches_tpucomp():
    """decode_batch with a history and the span against tpucomp's scan:
    err on every row, the span and the bytes on the rows without err."""
    payload, plen, olen, ss, hist, hl = _history_rows()
    want_out, want_err, want_span = _tpucomp_history_decode()
    batch = xh.batch_from_numpy(payload, plen, olen, ss, device="cpu")
    out, err, span = (t.numpy() for t in xh.decode_batch(
        *batch, BLOCK, hist=torch.from_numpy(hist.astype(np.uint8)),
        hist_len=torch.from_numpy(hl), want_span=True))
    np.testing.assert_array_equal(err, want_err)
    ok = ~err
    np.testing.assert_array_equal(span[ok], want_span[ok])
    np.testing.assert_array_equal(out[ok], want_out[ok])
    # both kinds of row: the vector's later blocks need their history
    assert ok.sum() >= 10 and err.sum() >= 2
    assert (hl[err] < BLOCK).all()


def test_parse_span_and_err_match_tpucomp():
    """The parse alone (its plain version), with hist_len and the span:
    err as tpucomp's on every row, the span on the rows without err; the
    span is where the next block starts."""
    payload, plen, olen, ss, hist, hl = _history_rows()
    _, want_err, want_span = _tpucomp_history_decode()
    batch = xh.batch_from_numpy(payload, plen, olen, ss, device="cpu")
    rec_pos, rec_val, p_final, errk, span = xh.parse_batch(
        *batch, BLOCK, hist_len=torch.from_numpy(hl), want_span=True)
    _, _, ovf = fill.fill_records_delta2(rec_pos, rec_val, BLOCK, BLOCK)
    err = ((errk != 0) | (ovf != 0) | (p_final < batch[2])).numpy()
    np.testing.assert_array_equal(err, want_err)
    np.testing.assert_array_equal(span.numpy()[~err], want_span[~err])
    # without want_span the parse returns its four planes, unchanged
    assert len(xh.parse_batch(*batch, BLOCK)) == 4
    s = _stream("cross_block")
    starts = t_xh._kraft_candidates(np.frombuffer(s, np.uint8))
    first = int(span[0])  # the vector's block 0 at the full reach
    assert starts[1] == 256 + first


def test_wide_resolve_matches_tpucomp():
    """The near walk and the far levels of the port (their plain
    versions) over ``[history | block]`` rows of 131072 against tpucomp's
    resolve of the same rows (``resolve_copies_wide`` and its far
    rounds): equal bytes on the rows without err."""
    payload, plen, olen, ss, hist, hl = _history_rows()
    _, want_err, _ = _tpucomp_history_decode()
    keep = np.nonzero(~want_err)[0][1::4]  # rows of both streams
    batch = xh.batch_from_numpy(payload[keep], plen[keep], olen[keep],
                                ss[keep], device="cpu")
    rec_pos, rec_val, _, _ = xh.parse_batch(*batch, BLOCK)
    vpack, tokpos, _ = fill.fill_records_delta2(rec_pos, rec_val, BLOCK,
                                                BLOCK)
    is_copy, disp, litv = xh.near_inputs(vpack, tokpos)
    h = torch.from_numpy(hist[keep])
    planes = (torch.cat([torch.zeros_like(h, dtype=torch.bool), is_copy], 1),
              torch.cat([torch.zeros_like(h), disp], 1),
              torch.cat([h & 0xFF, litv], 1))
    W = 2 * BLOCK
    got = common.far_rounds(resolve.resolve_near_ref(*planes), W,
                            resolve.SEG)
    want = np.asarray(t_common.resolve_copies_wide(
        *(jnp.asarray(p.numpy()) for p in planes)))
    j = np.arange(W)
    live = j[None, :] < (BLOCK + olen[keep])[:, None]
    np.testing.assert_array_equal(np.where(live, got.numpy(), 0),
                                  np.where(live, want, 0))

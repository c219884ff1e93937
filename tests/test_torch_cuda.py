"""tpucomp_torch's CUDA kernels against their plain PyTorch versions on
the card, at small seeded shapes that hold each kernel's edge cases.

Every test needs a CUDA card and skips without one.  The file imports
neither JAX nor tpucomp, and runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` sets JAX up for the other files.)
The Xpress Huffman and plain Xpress streams come from the repo's native
C encoder, which ``chip_smoke.Native`` builds with the host C compiler.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

import tpucomp_torch
from tpucomp_torch import stats
from chip_smoke import XH_VECTOR, XH_VECTOR_INPUT_SHA256, Native
from chip_smoke import XP_STREAM_INPUT_SHA256, XP_STREAM_SHA256
from tpucomp_torch.codecs import lznt1 as lz
from tpucomp_torch.codecs import xpress as xp
from tpucomp_torch.codecs import xpress_huff as xh
from tpucomp_torch.kernels import commit, common, fill, gather, lznt1_parse
from tpucomp_torch.kernels import huffman, match, resolve, runs, sort
from tpucomp_torch.kernels import xh_parse, xp_parse
from _spans import totals, traced
from test_torch_commit import segment_walk, walk_rows
from test_torch_far_row import CASES as FAR_CASES, WIDTHS as FAR_WIDTHS
from test_torch_far_row import NARROW, case_rows, far_row_model, narrow_rows
from test_torch_far_probe import CASES as PROBE_CASES
from test_torch_huffman_tables import CASES as HUFF_CASES
from test_torch_huffman_tables import _seeded, case_rows as huff_rows
from test_torch_far_probe import case_rows as probe_rows
from test_torch_fill import CASES as FILL_CASES, KEEP_DISTINCT
from test_torch_fill import case_rows as fill_rows, edges_of
from test_torch_lznt1_parse import CASES as PARSE_CASES
from test_torch_lznt1_parse import WIDTHS as PARSE_WIDTHS
from test_torch_lznt1_parse import case_rows as parse_rows, walk
from test_torch_resolve_near import CASES, case_inputs
from test_torch_run_matchlens import CASES as RUNS_CASES
from test_torch_run_matchlens import case_rows as runs_rows
from test_torch_xp_walk import literals, design_rows, pack, walk_steps
from test_torch_xp_walk import write_stream as xp_write_stream
from test_torch_xh_segment import (KINDS, Row, boundary_states, code_lengths,
                                   rows_batch, segment_parse, storm_tokens,
                                   table_bytes, write_stream)

pytestmark = pytest.mark.cuda

U = lz.CHUNK


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


def _parse_batch(dev):
    """Random token streams of every length (most malformed), hand-built
    malformed chunks, stored-raw and empty rows, and an all-literal one."""
    r = np.random.default_rng(1)
    N = 40
    payload = r.integers(0, 256, (N, lz.PAYLOAD_PAD), dtype=np.uint8)
    plen = r.integers(0, lz.PAYLOAD_PAD + 1, N).astype(np.int32)
    is_comp = r.random(N) < 0.8
    payload[0, :3], plen[0] = (1, 0, 0), 3  # disp 1 > p = 0
    payload[1, :2], plen[1] = (1, 7), 2  # ends after a copy's lo byte
    payload[2, :4], plen[2] = (0, 65, 66, 67), 4  # three literals: fine
    plen[3] = 0
    payload[4], plen[4] = 0, lz.PAYLOAD_PAD  # literals past 4096
    is_comp[:5] = True
    return lz.batch_from_numpy(payload.astype(np.int32), plen, is_comp, dev)


def test_parse_kernel_matches_plain(dev):
    batch = _parse_batch(dev)
    before = lznt1_parse.lznt1_parse.launches
    got = lznt1_parse.lznt1_parse(*batch)
    assert lznt1_parse.lznt1_parse.launches == before + 1
    want = lznt1_parse.lznt1_parse_ref(*batch)
    _assert_equal(got, want)
    err = want[3].cpu()
    assert err[:2].tolist() == [1, 1] and err[2] == 0 and err.sum() > 5
    assert want[2][4] == U  # the output filled; later bytes are ignored


def test_resolve_kernel_matches_plain(dev):
    r = np.random.default_rng(2)
    shape = (5, U)
    is_copy = torch.from_numpy(r.random(shape) < 0.6)
    disp = torch.from_numpy(np.where(
        r.random(shape) < 0.7, r.integers(0, 40, shape),
        r.integers(1, 5000, shape)).astype(np.int32))
    disp[0, ::97] = 0x30000  # clamped to 17 bits
    litv = torch.from_numpy(r.integers(0, 512, shape).astype(np.int32))
    args = [t.to(dev) for t in (is_copy, disp, litv)]
    _assert_equal([resolve.resolve_near(*args)],
                  [resolve.resolve_near_ref(*args)])


def test_far_level_kernel_matches_plain(dev):
    r = np.random.default_rng(3)
    x = r.integers(0, 256, (4, U)).astype(np.int32)
    tag = r.random((4, U)) < 0.5
    x[tag] = common.FAR_TAG | r.integers(0, U, tag.sum())
    x[1, 100], x[1, 200] = common.FAR_TAG | 200, common.FAR_TAG | 100  # cycle
    x[2, 7] = common.FAR_TAG | 9000  # outside the row: never chased
    x[2, 8:4000] = common.FAR_TAG | np.arange(7, 3999)  # one long chain
    x[3] = r.integers(0, 256, U)  # no tag at all
    xs = torch.from_numpy(x).to(dev)
    _assert_equal([gather.far_level(xs)], [gather.far_level_ref(xs)])


def test_decode_batch_on_card_matches_cpu(dev):
    batch = _parse_batch(dev)
    got = lz.decode_batch(*batch)
    want = lz.decode_batch(*(t.cpu() for t in batch))
    _assert_equal(got, want)


def test_empty_batch_launches_nothing(dev):
    batch = [t[:0] for t in _parse_batch(dev)]
    before = lznt1_parse.lznt1_parse.launches
    out, out_len, err = lz.decode_batch(*batch)
    assert out.shape == (0, U) and lznt1_parse.lznt1_parse.launches == before


def _hold_parse(batch):
    """One launch of lznt1_parse on ``batch`` against lznt1_parse_ref;
    returns the rows' windows and redone windows."""
    before = lznt1_parse.lznt1_parse.launches
    got = lznt1_parse.lznt1_parse(*batch)
    assert lznt1_parse.lznt1_parse.launches == before + 1
    _assert_equal(got, lznt1_parse.lznt1_parse_ref(*batch))
    return lznt1_parse.lznt1_parse.windows.cpu().numpy()


@pytest.mark.parametrize("P", PARSE_WIDTHS)
@pytest.mark.parametrize("name", list(PARSE_CASES))
def test_parse_kernel_on_cases(name, P, dev):
    """The edge rows of tests/test_torch_lznt1_parse.py: equal to the
    plain parse, with the windows of the numpy model."""
    rows = parse_rows(name, P)
    windows = _hold_parse([torch.from_numpy(x).to(dev) for x in rows])
    np.testing.assert_array_equal(windows, walk(*rows)[4])


def test_parse_kernel_past_one_wave(dev):
    """20,000 chunks (a wave holds 5,280): the native and edge rows
    over and over, random bytes among them."""
    parts = [parse_rows(name, lz.PAYLOAD_PAD) for name in PARSE_CASES]
    rows = [np.concatenate(x) for x in zip(*parts)]
    pick = np.random.default_rng(4).integers(0, len(rows[1]), 20000)
    payload, plen, is_comp = (x[pick] for x in rows)
    noise = np.random.default_rng(5).random(20000) < 0.1
    payload[noise] = np.random.default_rng(6).integers(
        0, 256, (int(noise.sum()), lz.PAYLOAD_PAD), dtype=np.uint8)
    windows = _hold_parse([torch.from_numpy(x).to(dev)
                           for x in (payload, plen, is_comp)])
    assert (windows[:, 1] <= 8).all()


def test_parse_kernel_on_unaligned_rows(dev):
    """Payload rows that start 3 bytes past an 8-byte boundary (a view
    at a storage offset), at an odd width too."""
    for P in (lz.PAYLOAD_PAD, 4613):
        parts = [parse_rows(name, P) for name in PARSE_CASES]
        payload, plen, is_comp = (np.concatenate(x) for x in zip(*parts))
        N = len(plen)
        flat = torch.zeros(N * P + 3, dtype=torch.uint8, device=dev)
        flat[3:] = torch.from_numpy(payload.reshape(-1)).to(dev)
        rows = flat[3:].view(N, P)
        assert rows.is_contiguous() and rows.data_ptr() % 8 == 3
        windows = _hold_parse([rows, torch.from_numpy(plen).to(dev),
                               torch.from_numpy(is_comp).to(dev)])
        np.testing.assert_array_equal(windows, walk(payload, plen,
                                                    is_comp)[4])


XU = 16384  # Xpress Huffman rows: every far level runs


def _xh_units():
    """Short units (the plain parse loops once per body byte) in 16 KiB
    rows: text-like, periodic, random (substep tier 3) and zeros (17)."""
    r = np.random.default_rng(6)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"pi ", b"rho "]
    text = b"".join(words[i] for i in r.integers(0, len(words), 1200))
    return [text[:5000], (b"abcabd" * 1500)[:8000] + text[:2000],
            r.permutation(np.tile(np.arange(256, dtype=np.uint8), 12))
            .tobytes(), bytes(XU)]


def _xh_batch(dev, native):
    """Valid units, their archive (resolved) encoding, and malformed rows:
    cut short, flipped bits, random code lengths, shorter than the table."""
    r = np.random.default_rng(8)
    units = _xh_units()
    streams = [native.xh_compress(u) for u in units]
    streams.append(native.xh_compress_opt(units[0],
                                          Native.OPT_RESOLVE_OFFSETS | 2 << 8))
    lens = [len(u) for u in units] + [len(units[0])]
    s = streams[0]
    flipped = bytearray(s)
    flipped[400] ^= 0x24
    streams += [s[:len(s) // 2], bytes(flipped),
                r.integers(0, 256, 256, dtype=np.uint8).tobytes() + s[256:],
                s[:100]]
    lens += [lens[0]] * 4
    return xh.pack_units(streams, lens, XU, dev), units


def _hold_xh_parse(args, U, ref=True):
    """The parse kernel, one launch, against xh_parse_ref on the CPU (or,
    with ``ref`` False, the segment model alone, itself held to
    xh_parse_ref on the CPU); its rounds against the segment model's.
    Returns the plain version's outputs (on the CPU) and the rounds."""
    cpu = [a.cpu() for a in args]
    *model, rounds = (torch.from_numpy(a) for a in segment_parse(
        *(a.numpy() for a in cpu), U))
    want = xh_parse.xh_parse_ref(*cpu, U) if ref else model
    if ref:
        _assert_equal(model, want)
    before = xh_parse.xh_parse.launches
    got = xh_parse.xh_parse(*(a.cuda() for a in args), U)
    assert xh_parse.xh_parse.launches == before + 1
    _assert_equal(got, want)
    assert torch.equal(xh_parse.xh_parse.rounds.cpu(), rounds)
    return want, rounds


def test_xh_parse_kernel_matches_plain(dev):
    batch, units = _xh_batch(dev, Native())
    args = xh.parse_inputs(*batch)
    want, _ = _hold_xh_parse(args, XU)
    bad = ((want[3] != 0) | (want[2] < batch[2].cpu()))
    assert not bad[:len(units) + 1].any() and bad[len(units) + 1:].sum() >= 2
    assert set(batch[3].tolist()) >= {3, 5, 17}


def test_xh_parse_kernel_refuses_wider_bodies(dev):
    args = list(xh.parse_inputs(*_xh_batch(dev, Native())[0]))
    args[0] = torch.zeros((args[0].shape[0], xh_parse.MAX_BODY + 16),
                          dtype=torch.uint8, device=dev)
    before = xh_parse.xh_parse.launches
    with pytest.raises(ValueError, match="shared memory"):
        xh_parse.xh_parse(*args, XU)
    assert xh_parse.xh_parse.launches == before


def _segment_rows():
    """Rows at U = 65536 rich in what a segment boundary can fall on, at
    tiers 5 and 3: escapes of 1 byte (each flips the word parity), u16
    and u32 escapes, far offsets; the wrap row (a u32 length of 2**31 -
    3); a body shorter than a segment (tier 5, and tier 3 with segments
    too short for sub-segments), an empty body, one shorter than the
    table, a row cut inside its stream."""
    r = np.random.default_rng(21)
    rows = []
    for tier in (5, 3):
        for kinds in (("u16", "esc8", "far"), ("u32", "esc8")):
            rows.append(write_stream(code_lengths(tier),
                                     storm_tokens(r, 60000, kinds)))
    ln = code_lengths(5)
    rows.append((write_stream(ln, [("lit", 1)] * 20 + [("match", 3, 2**31)]
                              + [("lit", 2)] * 30)[0], 1000))
    short = write_stream(ln, [("lit", 65), ("lit", 66), ("match", 1, 5)])
    short3 = write_stream(code_lengths(3), [("lit", i % 128)
                                            for i in range(300)])
    rows += [short, short3, (table_bytes(ln), 10),
             (table_bytes(ln)[:100], 50),
             (rows[0][0][:len(rows[0][0]) // 2 | 1], rows[0][1])]
    return rows


def test_xh_parse_kernel_on_segment_rows(dev):
    """Each kind of boundary state lands on a segment boundary of the
    kernel's own geometry in some row."""
    U = 1 << 16
    args = rows_batch(_segment_rows(), U)
    _hold_xh_parse(args, U)
    hit = set()
    for n in range(4):
        row = Row(*(a[n].numpy() for a in args), U)
        S, nseg = xh_parse.segments(row.blen, row.ss)
        states = boundary_states(row)
        hit |= {kind for kind, f in KINDS.items()
                for t in range(1, nseg) if f(states[t * S])}
    assert hit == set(KINDS)


def test_xh_parse_kernel_on_a_random_unit(dev):
    """64 KiB of seeded random bytes (tier 3), alone and beside a short
    row, against the segment model (xh_parse_ref takes minutes here);
    then 80 copies of it in one launch behind the short row, each equal
    to the model's row (every tier-3 row of a launch takes the same
    path)."""
    r = np.random.default_rng(22)
    unit = r.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
    stream = Native().xh_compress(unit)
    text = _xh_units()[0]
    short = (Native().xh_compress(text), len(text))
    for rows in ([(stream, 1 << 16)], [short, (stream, 1 << 16)]):
        args = rows_batch(rows, 1 << 16)
        assert int(args[3][-1]) == 3
        want, rounds = _hold_xh_parse(args, 1 << 16, ref=False)
        assert int(want[2][-1]) == 1 << 16 and int(want[3][-1]) == 0
    args = rows_batch([short] + [(stream, 1 << 16)] * 80, 1 << 16)
    got = xh_parse.xh_parse(*(a.cuda() for a in args), 1 << 16)
    _assert_equal([g[1:] for g in got], [w[1:].expand(80, *w.shape[1:])
                                          for w in want])
    assert (xh_parse.xh_parse.rounds[1:].cpu() == rounds[1]).all()


def test_fill_kernel_matches_plain(dev):
    """Monotone records with adjacent repeats and SENT or -1 gaps, R below
    and above U, and a keep that binds; then the edge rows at both R."""
    r = np.random.default_rng(9)
    W = 4096
    for R in (3000, 9000):
        pos = np.sort(r.integers(-3, W + 40, (6, R)), axis=1).astype(np.int32)
        pos[r.random((6, R)) < 0.2] = common.SENT_KEY
        pos[1] = -1
        val = r.integers(0, 1 << 23, (6, R)).astype(np.int32)
        args = [torch.from_numpy(a).to(dev) for a in (pos, val)]
        for keep in (None, 500):
            _assert_equal(fill.fill_records_delta2(*args, W, keep),
                          fill.fill_records_delta2_ref(*args, W, keep))
        _hold_fill_edges(W, R, dev)


def _hold_fill_edges(W, R, dev):
    """The edge rows of tests/test_torch_fill.py on the kernel's own tile
    edges, through both forms of the kernel, one launch a call."""
    rng = np.random.default_rng(W + R)
    edges = edges_of(R, fill.TILE_SLOTS, fill.PER_THREAD)
    for name in FILL_CASES:
        pos, val = fill_rows(name, R, W, edges, rng)
        args = [torch.from_numpy(a).to(dev) for a in (pos, val)]
        keeps = (None, KEEP_DISTINCT, KEEP_DISTINCT - 1) \
            if name == "keep" else (None,)
        for keep in keeps:
            before = fill.fill_records_delta2.launches
            got = fill.fill_records_delta2(*args, W, keep)
            assert fill.fill_records_delta2.launches == before + 1
            _assert_equal(got, fill.fill_records_delta2_ref(*args, W, keep))
        before = fill.fill_records_delta.launches
        got = fill.fill_records_delta(*args, W)
        assert fill.fill_records_delta.launches == before + 1
        _assert_equal([got], [fill.fill_records_delta_ref(*args, W)])


@pytest.mark.parametrize("W,R", [(4099, 5000), (65536, 60000),
                                 (65536, 70000)])
def test_fill_kernel_on_edge_rows(W, R, dev):
    """:func:`_hold_fill_edges` at the other widths, R below and above W
    (one tile and several), the zeros unit's row and an all-literal row
    among the edge rows; W = 4099 takes the scalar stores (W = 4096 is
    held in :func:`test_fill_kernel_matches_plain`)."""
    _hold_fill_edges(W, R, dev)


def test_fill_kernel_on_unaligned_records(dev):
    """Record planes at a storage offset of one int (the kernel's 4-byte
    loads) and an empty batch (no launch)."""
    rng = np.random.default_rng(13)
    pos, val = fill_rows("random", 9000, 4096, [], rng)
    flat = torch.zeros((2, pos.size + 1), dtype=torch.int32, device=dev)
    views = [flat[k, 1:].view(pos.shape) for k in range(2)]
    for v, a in zip(views, (pos, val)):
        v.copy_(torch.from_numpy(a))
    assert views[0].data_ptr() % 16
    _assert_equal(fill.fill_records_delta2(*views, 4096),
                  fill.fill_records_delta2_ref(*views, 4096))
    _assert_equal([fill.fill_records_delta(*views, 4096)],
                  [fill.fill_records_delta_ref(*views, 4096)])
    before = fill.fill_records_delta.launches
    assert fill.fill_records_delta(views[0][:0], views[1][:0], 4096).shape \
        == (0, 4096)
    assert fill.fill_records_delta.launches == before


def test_lznt1_decode_batch_of_native_chunks_on_card(dev):
    """Native-encoded chunks (text, a run, random and zero bytes) decoded
    on the card equal the CPU's decode, the fill launched once."""
    r = np.random.default_rng(14)
    words = [b"fill ", b"the ", b"spans ", b"of ", b"records "]
    data = (b"".join(words[i] for i in r.integers(0, 5, 9000))[:40000]
            + b"ab" * 5000 + r.integers(0, 256, 9000, dtype=np.uint8)
            .tobytes() + bytes(12000))
    payloads, comps = lz.split_stream(Native().lznt1_compress(data))
    batch = lz.pack_chunks(payloads, comps, dev)
    before = fill.fill_records_delta.launches
    got = lz.decode_batch(*batch)
    assert fill.fill_records_delta.launches == before + 1
    _assert_equal(got, lz.decode_batch(*(t.cpu() for t in batch)))
    assert lz.joined_output(got[0], got[1]) == data


def _far_states(width):
    """Near-walk-shaped states: chains within and across 4 KiB segments,
    cycles, and sources outside the row or past 17 bits."""
    r = np.random.default_rng(10)
    x = r.integers(0, 256, (4, width)).astype(np.int32)
    tag = r.random((4, width)) < 0.5
    src = np.where(r.random((4, width)) < 0.5,
                   r.integers(0, 4096, (4, width)),
                   r.integers(0, width, (4, width)))
    x[tag] = common.FAR_TAG | src[tag]
    x[1, 100], x[1, 200] = common.FAR_TAG | 200, common.FAR_TAG | 100
    x[2, 7] = common.FAR_TAG | (width + 9)
    x[2, 8] = common.FAR_TAG | (1 << 17) | 5
    x[3, 4096:] = common.FAR_TAG | np.arange(4095, width - 1)  # long chain
    return x


@pytest.mark.parametrize("width,case", [
    (XU, "far_states"), (65536, "far_states"),
    *((w, c) for w in (4096, 65536) for c in PROBE_CASES)])
def test_far_kernels_match_plain(width, case, dev):
    """Near-walk states (``_far_states``, or an edge case of
    ``tests/test_torch_far_probe.py``) through the 4 KiB level, the probes
    at 0, 1, 2 (tpucomp's) and 5 rounds, and the row level."""
    x = (_far_states(width) if case == "far_states"
         else probe_rows(case, width))
    xs = torch.from_numpy(x).to(dev)
    seg_args = (xs, common.SEG_LEVEL, common.SEG_LEVEL_CAP, False)
    seg = gather.far_level(*seg_args)
    _assert_equal([seg], [gather.far_level_ref(*seg_args)])
    for states in (xs, seg):
        for rounds in (0, 1, 2, 5):
            before = gather.far_probe.launches
            got = gather.far_probe(states, rounds)
            assert gather.far_probe.launches == before + 1
            _assert_equal([got], [gather.far_probe_ref(states, rounds)])
    _assert_equal([gather.far_row(seg)], [gather.far_row_ref(seg)])
    _assert_equal([gather.far_row(xs)], [gather.far_row_ref(xs)])


@pytest.mark.parametrize("U", [1001, 4099])
def test_far_probe_kernel_on_unaligned_rows(U, dev):
    """Widths that are no multiple of 4, and rows that start off a 16-byte
    boundary: the probe's scalar loads and stores."""
    for case in PROBE_CASES:
        xs = torch.from_numpy(probe_rows(case, U)).to(dev)
        for states in (xs, xs[1:]):
            for rounds in (0, 1, 2, 5):
                _assert_equal([gather.far_probe(states, rounds)],
                              [gather.far_probe_ref(states, rounds)])


def _hold_far_row(xs):
    """One launch of far_row on ``xs`` against far_row_ref, and against
    the numpy model of tests/test_torch_far_row.py with the branch of
    every row.  Returns the rows that ran the round loop (bool numpy)."""
    before = gather.far_row.launches
    got = gather.far_row(xs)
    assert gather.far_row.launches == before + 1
    _assert_equal([got], [gather.far_row_ref(xs)])
    want, looped = far_row_model(xs.cpu().numpy())
    assert torch.equal(got.cpu(), torch.from_numpy(want))
    assert gather.far_row.looped.cpu().tolist() == looped.astype(int).tolist()
    return looped


@pytest.mark.parametrize("U", FAR_WIDTHS)
@pytest.mark.parametrize("name", list(FAR_CASES))
def test_far_row_kernel_on_cases(name, U, dev):
    x, looped = case_rows(name, U)
    assert (_hold_far_row(torch.from_numpy(x).to(dev)) == looped).all()


@pytest.mark.parametrize("U", NARROW)
def test_far_row_kernel_on_narrow_rows(U, dev):
    x, looped = narrow_rows(U)
    assert (_hold_far_row(torch.from_numpy(x).to(dev)) == looped).all()


def test_far_row_kernel_on_a_mixed_batch(dev):
    """Every case's rows at 65536 in one launch, swept and round-loop rows
    interleaved."""
    rows = [case_rows(name, 65536) for name in FAR_CASES]
    perm = np.random.default_rng(40).permutation(sum(len(r[1]) for r in rows))
    x = np.concatenate([r[0] for r in rows])[perm]
    looped = np.concatenate([r[1] for r in rows])[perm]
    assert looped.any() and not looped.all()
    assert (_hold_far_row(torch.from_numpy(x).to(dev)) == looped).all()


def test_far_row_kernel_past_one_wave(dev):
    """1000 rows of 8192, more than the 792 blocks an H100 holds at once,
    drawn from every case."""
    rows = [case_rows(name, 8192) for name in FAR_CASES]
    x = np.concatenate([r[0] for r in rows])
    looped = np.concatenate([r[1] for r in rows])
    pick = np.random.default_rng(41).integers(0, len(x), 1000)
    assert (_hold_far_row(torch.from_numpy(x[pick]).to(dev))
            == looped[pick]).all()


def test_far_row_kernel_on_unaligned_rows(dev):
    """A contiguous view 4 bytes into its storage at U = 65536: the
    kernel's build with 4-byte copies and stores (U % 4 != 0 takes it
    too: the 4610 cases)."""
    x = np.concatenate([case_rows(n, 65536)[0]
                        for n in ("run_d1", "cycles", "dead", "later_chunk")])
    flat = torch.zeros(x.size + 1, dtype=torch.int32, device=dev)
    xs = flat[1:].view(x.shape)
    xs.copy_(torch.from_numpy(x))
    assert xs.is_contiguous() and xs.data_ptr() % 16
    _hold_far_row(xs)


def test_far_row_kernel_on_decoded_states(dev):
    """XH states after the 4 KiB level and the probes (its units and
    malformed rows at 16 KiB, and the archive encoding), plain Xpress
    states after the 4 KiB level (units and malformed rows at 64 KiB): the
    valid units' rows are all swept."""
    native = Native()
    batch, units = _xh_batch(dev, native)
    rec_pos, rec_val, _, _ = xh_parse.xh_parse(*xh.parse_inputs(*batch), XU)
    filled = fill.fill_records_delta2(rec_pos, rec_val, XU, XU)
    near = resolve.resolve_near(*xh.near_inputs(filled[0], filled[1]))
    seg = gather.far_level(near, common.SEG_LEVEL, common.SEG_LEVEL_CAP,
                           False)
    for states in (seg, gather.far_probe(seg)):
        assert not _hold_far_row(states)[:len(units) + 1].any()
    rows, units = _xp_rows(native)
    batch = xp.pack_units([s for s, _ in rows], [n for _, n in rows], 65536,
                          dev)
    rec_pos, rec_val, _, _ = xp_parse.xp_parse(*batch, 65536)
    filled = fill.fill_records_delta2(rec_pos, rec_val, 65536)
    near = resolve.resolve_near(*xh.near_inputs(filled[0], filled[1]))
    seg = gather.far_level(near, common.SEG_LEVEL, common.SEG_LEVEL_CAP,
                           False)
    assert ((seg & common.FAR_TAG) != 0)[:len(units)].any()
    assert not _hold_far_row(seg)[:len(units)].any()


def test_resolve_kernel_matches_plain_on_wide_rows(dev):
    r = np.random.default_rng(11)
    shape = (3, XU)
    is_copy = torch.from_numpy(r.random(shape) < 0.6)
    disp = torch.from_numpy(np.where(
        r.random(shape) < 0.7, r.integers(0, 40, shape),
        r.integers(1, 9000, shape)).astype(np.int32))
    litv = torch.from_numpy(r.integers(0, 512, shape).astype(np.int32))
    args = [t.to(dev) for t in (is_copy, disp, litv)]
    _assert_equal([resolve.resolve_near(*args)],
                  [resolve.resolve_near_ref(*args)])


def _resolve_rows(N, U, dev):
    """N rows of width U, row i from case i mod 9 of
    ``test_torch_resolve_near.CASES``, on the card."""
    per = -(-N // len(CASES))
    cases = [case_inputs(name, per, U, seed=N) for name in CASES]
    return [torch.from_numpy(np.stack(p, axis=1).reshape(-1, U)[:N]).to(dev)
            for p in zip(*cases)]


@pytest.mark.parametrize("U", [512, 4096, 65536, 131072])
@pytest.mark.parametrize("name", list(CASES))
def test_resolve_kernel_on_adversarial_segments(name, U, dev):
    N = {512: 13, 4096: 3, 65536: 2, 131072: 2}[U]
    args = [torch.from_numpy(p).to(dev) for p in case_inputs(name, N, U)]
    before = resolve.resolve_near.launches
    got = resolve.resolve_near(*args)
    assert resolve.resolve_near.launches == before + 1
    _assert_equal([got], [resolve.resolve_near_ref(*args)])


@pytest.mark.parametrize("N, U", [(1, 4096), (3, 4096), (1000, 4096),
                                  (1, 512), (3, 512), (13, 512)])
def test_resolve_kernel_on_partial_blocks(N, U, dev):
    """A block takes 8 segments: a row of 4096 fills one, rows of 512
    leave the last block partly empty unless N % 8 == 0."""
    args = _resolve_rows(N, U, dev)
    before = resolve.resolve_near.launches
    got = resolve.resolve_near(*args)
    assert resolve.resolve_near.launches == before + 1
    _assert_equal([got], [resolve.resolve_near_ref(*args)])


def test_resolve_kernel_on_unaligned_planes(dev):
    """Planes that are not 16-byte aligned take the kernel's 4-byte path."""
    args = []
    for t in _resolve_rows(9, 4096, dev):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        args.append(buf[1:].view(t.shape))
        args[-1].copy_(t)
    assert all(t.data_ptr() % 16 for t in args)
    _assert_equal([resolve.resolve_near(*args)],
                  [resolve.resolve_near_ref(*args)])


@pytest.mark.parametrize("fast_resolve", [False, True])
def test_xh_decode_batch_on_card_matches_cpu(fast_resolve, dev):
    batch, units = _xh_batch(dev, Native())
    got = xh.decode_batch(*batch, XU, fast_resolve=fast_resolve)
    want = xh.decode_batch(*(t.cpu() for t in batch), XU,
                           fast_resolve=fast_resolve)
    _assert_equal(got, want)
    out = got[0].cpu().numpy()
    for k, u in enumerate(units):
        assert out[k, :len(u)].tobytes() == u


@pytest.mark.parametrize("fast_resolve", [False, True])
def test_xh_decode_batch_on_card_matches_cpu_at_64k(fast_resolve, dev):
    """64 KiB units with short bodies (the plain parse loops once per body
    byte on the CPU): periodic, repeated text, zeros, and their archive
    (resolved) encodings."""
    native = Native()
    text = _xh_units()[0]
    units = [(b"abcabd" * 11000)[:65536], (text * 14)[:65536], bytes(65536)]
    streams = [native.xh_compress(u) for u in units]
    streams += [native.xh_compress_opt(u, Native.OPT_RESOLVE_OFFSETS | 2 << 8)
                for u in units[:2]]
    lens = [65536] * len(streams)
    batch = xh.pack_units(streams, lens, 65536, dev)
    got = xh.decode_batch(*batch, 65536, fast_resolve=fast_resolve)
    want = xh.decode_batch(*(t.cpu() for t in batch), 65536,
                           fast_resolve=fast_resolve)
    _assert_equal(got, want)
    out = got[0].cpu().numpy()
    for k, u in enumerate(units + units[:2]):
        assert out[k].tobytes() == u


def _byte_rows(U, seed):
    """Zeros, runs of periods 1-3 with breaks, random bytes, a short chunk
    in zero padding, and slowly varying text-like bytes."""
    r = np.random.default_rng(seed)
    x = np.zeros((7, U), np.uint8)
    x[1] = 5
    x[1, r.integers(0, U, 3)] = 6
    x[2] = np.tile([1, 2], U)[:U]
    x[3] = np.tile([7, 8, 9], U)[:U]
    x[4] = r.integers(0, 256, U)
    x[5, :37] = r.integers(0, 4, 37)
    x[6] = r.integers(0, 3, U)
    return x


@pytest.mark.parametrize("U,case", [
    *((u, "byte_rows") for u in (512, 1001, 4096, 5000, 65536)),
    *((u, c) for u in (4096, 65536) for c in RUNS_CASES)])
def test_run_matchlens_kernel_matches_plain(U, case, dev):
    """``_byte_rows``, or an edge case of ``tests/test_torch_run_matchlens.py``
    built for the kernel's tiles and for narrow ones."""
    x = (_byte_rows(U, U) if case == "byte_rows" else np.concatenate(
        [runs_rows(case, U, tw) for tw in (runs.TILE, 32)]))
    xs = torch.from_numpy(x).to(dev)
    # two launches, 4 displacements each at most; the last past the row
    disps = (1, 2, 3, 7, 255, 300, U + 5)
    before = runs.run_matchlens.launches
    got = runs.run_matchlens(xs, disps)
    assert runs.run_matchlens.launches == before + 2
    _assert_equal(got, runs.run_matchlens_ref(xs, disps))


@pytest.mark.parametrize("U", [73728, 131072])
def test_stream_width_kernels_match_plain(U, dev):
    """The run matcher and the row sort at the stream encoder's [8 KiB
    history | 64 KiB lane] rows (73,728) and at their widest (131072):
    ``_byte_rows``; random unique keys with a payload plane; the match
    finder's hash keys of those rows at 17 position bits, and the
    un-sort of their positions."""
    r = np.random.default_rng(U + 3)
    x = torch.from_numpy(_byte_rows(U, U)).to(dev)
    disps = (1, 2, 3)
    _assert_equal(runs.run_matchlens(x, disps),
                  runs.run_matchlens_ref(x, disps))
    key = torch.from_numpy(np.stack([r.permutation(U) for _ in range(4)])
                           .astype(np.int32) - (1 << 20)).to(dev)
    pay = torch.from_numpy(r.integers(-(1 << 31), 1 << 31, key.shape)
                           .astype(np.int32)).to(dev)
    _assert_equal(sort.sort_rows((key, pay)), sort.sort_rows_ref((key, pay)))
    hkey = match.hash_keys(x, 13, 17)
    got = sort.sort_rows((hkey,))
    _assert_equal(got, sort.sort_rows_ref((hkey,)))
    spos = got[0] & ((1 << 17) - 1)
    unsort = (spos, hkey)
    _assert_equal(sort.sort_rows(unsort), sort.sort_rows_ref(unsort))


def test_run_matchlens_kernel_refuses_wide_rows(dev):
    with pytest.raises(ValueError, match="at most 131072"):
        runs.run_matchlens(torch.zeros((1, 131073), dtype=torch.uint8,
                                       device=dev), (1, 2, 3))


def _sort_keys(U, r):
    """Eight rows of unique keys: a permutation, values of both signs,
    reversed and sorted rows, the widest keys, keys that vary only in
    their top bits (the high byte at U = 256, bit 31 alone at U = 2), and
    keys whose low 7 bits are the same nonzero bits."""
    key = np.stack([r.permutation(U) for _ in range(8)]).astype(np.int64)
    key[1] = r.choice(np.arange(-(1 << 30), 1 << 30, 7919), U, replace=False)
    key[2] = np.arange(U)[::-1]  # reversed
    key[3] = np.arange(U)  # already sorted
    key[4, :3] = (1 << 31) - 1 - np.arange(min(3, U))  # the widest keys
    top = max(1, (U - 1).bit_length())
    key[5] = (r.permutation(U) << (32 - top)) - (1 << 31)
    key[6] = (r.permutation(U) << 7) | 0x55
    return key.astype(np.int32)


@pytest.mark.parametrize("U", [1, 2, 256, 512, 4096, 8192, 8193, 16384,
                               65536, 1000, 20000])
def test_sort_rows_kernel_matches_plain(U, dev):
    r = np.random.default_rng(U)
    key = _sort_keys(U, r)
    planes = [torch.from_numpy(key).to(dev)] + [
        torch.from_numpy(r.integers(-(1 << 31), 1 << 31, key.shape)
                         .astype(np.int32)).to(dev) for _ in range(8)]
    for P in (1, 2, 9):
        _assert_equal(sort.sort_rows(planes[:P]),
                      sort.sort_rows_ref(planes[:P]))


@pytest.mark.parametrize("U", [300, 4096, 20000])
def test_sort_rows_kernel_is_stable(U, dev):
    """Rows of few distinct keys (only bit 31, only the high byte, or one
    middle bit differing; small keys of both signs) keep equal keys in
    column order, as ``torch.sort(stable=True)`` does: an unstable digit
    pass would not."""
    r = np.random.default_rng(U + 1)
    key = np.stack([
        np.where(r.integers(0, 2, U) == 1, -(1 << 31), 0),
        (r.integers(0, 256, U) << 24) - (1 << 31),
        r.choice([5, 5 | (1 << 20)], U),
        r.integers(-3, 3, U)]).astype(np.int32)
    key = torch.from_numpy(key).to(dev)
    col = torch.arange(U, dtype=torch.int32, device=dev).expand(4, U)
    col = col.contiguous()
    s_key, idx = torch.sort(key, dim=1, stable=True)
    _assert_equal(sort.sort_rows((key, col)), (s_key, col.gather(1, idx)))


def test_sort_rows_kernel_on_hash_keys(dev):
    """The match finder's hash keys on seeded bytes at LZNT1's shape,
    [8208, 4096] (25 varying bits, 3 passes in one block), and on 64 KiB
    rows (29 bits, 4 passes in tiles)."""
    r = np.random.default_rng(23)
    for N, U, pos_bits, passes in ((8208, 4096, 12, 3), (16, 65536, 16, 4)):
        x = torch.from_numpy(r.integers(0, 256, (N, U), dtype=np.uint8))
        key = match.hash_keys(x.to(dev), 13, pos_bits)
        assert int(sort.digit_passes(key).min()) == passes
        pos = torch.arange(U, dtype=torch.int32, device=dev).expand(N, U)
        planes = (key, pos.contiguous())
        _assert_equal(sort.sort_rows(planes), sort.sort_rows_ref(planes))


def test_sort_rows_kernel_many_planes_and_refusals(dev):
    r = np.random.default_rng(17)
    key = torch.from_numpy(np.stack([r.permutation(1024) for _ in range(3)])
                           .astype(np.int32)).to(dev)
    planes = [key] + [key * k for k in range(1, 20)]  # 19 payload planes
    before = sort.sort_rows.launches
    _assert_equal(sort.sort_rows(planes), sort.sort_rows_ref(planes))
    assert sort.sort_rows.launches == before + 2
    with pytest.raises(ValueError, match="at most 131072"):
        sort.sort_rows((torch.zeros((1, 131073), dtype=torch.int32,
                                    device=dev),))
    with pytest.raises(ValueError, match="contiguous"):
        sort.sort_rows((key[:, ::2],))


def _hold_walk_to_plain(ins, dev):
    """Both walks on the card against greedy_commit_ref (on the CPU),
    one launch each; their rounds against the numpy model's.  Returns
    the rounds."""
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in ins]
    want = commit.greedy_commit_ref(*args, layout=True)
    _, want_rounds = segment_walk(*ins)
    nseg = commit.segments(args[0].shape[1])
    for fn, w in ((commit.greedy_commit, want[:1]),
                  (commit.greedy_commit_layout, want)):
        before = fn.launches
        got = fn(*(a.to(dev) for a in args))
        assert fn.launches == before + 1
        _assert_equal(got if isinstance(got, tuple) else (got,), w)
        rounds = fn.rounds.cpu().numpy()
        np.testing.assert_array_equal(rounds, want_rounds)
        assert 1 <= rounds.min() and rounds.max() <= nseg
    return want_rounds


@pytest.mark.parametrize("N,n", [(70, 4096), (33, 1000), (1, 129),
                                 (4, 65536), (3, 20000), (514, 4096)])
def test_greedy_commit_kernel_matches_plain(N, n, dev):
    r = np.random.default_rng(N * n)
    is_match = r.random((N, n)) < 0.4
    is_match[0] = False  # a row with no match
    best_len = r.integers(1, 90, (N, n)).astype(np.int32)
    okpos = np.ones((N, n), bool)
    okpos[-1, n // 3:] = False  # a short chunk
    _hold_walk_to_plain((is_match, best_len, okpos), dev)


@pytest.mark.parametrize("n", [129, 4096, 20000, 65536])
def test_greedy_commit_kernel_on_edge_rows(n, dev):
    """A constant jump, a row whose segment chains never meet (one round
    a segment), jumps to n and past it (65536 at p = 0), negative, zero
    and INT32_MAX lengths with is_match set, okpos holes, an all-false
    okpos row."""
    names, *ins = walk_rows(n, seed=n, wide=True)
    rounds = _hold_walk_to_plain(ins, dev)
    assert rounds[names.index("never meets")] == commit.segments(n)


def test_greedy_commit_kernel_refuses_what_it_does_not_take(dev):
    wide = torch.zeros((1, commit.MAX_ROW + 1), dtype=torch.bool, device=dev)
    args = (wide, wide.int(), wide)
    with pytest.raises(ValueError, match="at most 65536"):
        commit.greedy_commit(*args)
    with pytest.raises(ValueError, match="contiguous"):
        commit.greedy_commit_layout(*(a[:, ::2] for a in args))


def test_greedy_commit_kernel_on_matches_of_text(dev):
    """The lengths xp.find_matches gives on seeded text at 64 KiB, one
    unit full and one short (okpos false past its end)."""
    text = _encode_inputs() * 4
    units = np.frombuffer(text[:2 * 65536], np.uint8).reshape(2, 65536)
    ulen = torch.tensor([65536, 40000], dtype=torch.int32, device=dev)
    best_len, _, use_match, okpos = xp.find_matches(
        torch.from_numpy(units.copy()).to(dev), ulen)
    rounds = _hold_walk_to_plain(
        [t.cpu().numpy() for t in (use_match, best_len, okpos)], dev)
    assert (best_len > 256).any()  # long matches span segments
    assert rounds.max() < commit.segments(65536)


def test_hash_best_match_on_card_matches_cpu(dev):
    x = np.concatenate([_byte_rows(4096, 3), _byte_rows(4096, 4)])
    x[7:, 1000:3000] = np.tile(x[4, :100], 20)  # long repeats: saturation
    xs = torch.from_numpy(x)
    for seed, max_disp in ((3, None), (5, 900)):
        kw = dict(hash_bits=13, num_cands=3, cap=32, seed=seed,
                  max_disp=max_disp)
        got = match.hash_best_match(xs.to(dev), 4096, **kw)
        want = match.hash_best_match(xs, 4096, **kw)
        _assert_equal(got, want)


def _encode_inputs():
    r = np.random.default_rng(21)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"pi "]
    text = b"".join(words[i] for i in r.integers(0, len(words), 6000))
    return (text[:20000] + r.integers(0, 256, 5000, dtype=np.uint8).tobytes()
            + bytes(9000) + (b"abc" * 3000) + text[:777])


def test_encode_batch_on_card_matches_cpu(dev):
    chunks, clen = lz.split_chunks(_encode_inputs())
    args = torch.from_numpy(chunks), torch.from_numpy(clen)
    got = lz.encode_batch(*(t.to(dev) for t in args))
    _assert_equal(got, lz.encode_batch(*args))


def test_compress_on_card_matches_cpu_and_round_trips(dev):
    data = _encode_inputs()
    stream = tpucomp_torch.compress("lznt1", data)
    assert stream == tpucomp_torch.compress("lznt1", data, device="cpu")
    assert tpucomp_torch.decompress("lznt1", stream) == data
    assert Native().lznt1_decompress(stream, len(data)) == data
    units = [data[i:i + 4096] for i in range(0, len(data), 4096)] + [b"", b"x"]
    got = tpucomp_torch.compress_batch("lznt1", units)
    assert got == tpucomp_torch.compress_batch("lznt1", units, device="cpu")
    assert tpucomp_torch.decompress_batch("lznt1", got) == units


def _xp_rows(native):
    """Plain Xpress (stream, out_len) rows: native C units of 64 KiB and
    shorter (a row of zeros among them: few, long matches), then malformed
    ones (cut short, a match before the start, and a u32 length that wraps
    int32 and moves the position backwards)."""
    r = np.random.default_rng(31)
    units = [_encode_inputs()[:12000], bytes(65536),
             r.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
             (b"abcabd" * 900)[:5000], b"z"]
    rows = [(native.xpress_compress(u), len(u)) for u in units]
    s = rows[0][0]
    wrap = bytes([0xFF, 0xFF, 0xFF, 0x4F, 7, 7, 0, 0x0F, 0xFF, 0, 0,
                  0xFD, 0xFF, 0xFF, 0x7F, 8, 9])
    rows += [(s[:len(s) // 2], 65536),
             (s[:3] + bytes([s[3] | 0x80, 8, 0]) + s[6:], 65536),
             (wrap, 4)]
    return rows, units


def _xp_parse_launch(batch, U):
    """One launch of the parse: its outputs, the launch counted once, the
    walk's steps equal to the numpy model's."""
    before = xp_parse.xp_parse.launches
    got = xp_parse.xp_parse(*batch, U)
    assert xp_parse.xp_parse.launches == before + 1
    torch.cuda.synchronize()
    want_steps = walk_steps(*(t.cpu().numpy() for t in batch), U)
    assert xp_parse.xp_parse.steps.cpu().tolist() == want_steps.tolist()
    return got


@pytest.mark.parametrize(
    "rows", ["units", "design", "design, byte loads", "random x80"])
def test_xp_parse_kernel_matches_plain(rows, dev):
    """The kernel against the plain parse, exactly: native C units and
    malformed rows at 64 KiB; the rows built for the skeleton walk's edges
    (tests/test_torch_xp_walk.py) at 4096, one with out_len past U, also
    at a payload width that is no multiple of 16 (the kernel's build with
    byte loads and stores); and 80 copies of a 64 KiB unit of random bytes
    (flag words of 32 literals) in one launch, against the plain parse of
    one copy."""
    if rows == "units":
        rows, units = _xp_rows(Native())
        batch = xp.pack_units([s for s, _ in rows], [n for _, n in rows],
                              65536, dev)
        got = _xp_parse_launch(batch, 65536)
        want = xp_parse.xp_parse_ref(*batch, 65536)
        _assert_equal(got, want)
        bad = ((want[3] != 0) | (want[2] < batch[2])).cpu()
        assert not bad[:len(units)].any() and bad[len(units):].all()
        assert want[2][-1] == 3 - (1 << 31) and want[3][-1] == 0  # the wrap
    elif rows.startswith("design"):
        payload, plen, olen = pack(list(design_rows().values()))
        if rows == "design, byte loads":
            payload = np.pad(payload, ((0, 0), (0, 5)))
        batch = [torch.from_numpy(a).to(dev) for a in (payload, plen, olen)]
        got = _xp_parse_launch(batch, 4096)
        _assert_equal(got, xp_parse.xp_parse_ref(*batch, 4096))
    else:
        rand, _ = xp_write_stream(literals(65536, 20))
        one = [torch.from_numpy(a).to(dev)
               for a in pack([(rand, len(rand), 65536)])]
        batch = [t.expand(80, *t.shape[1:]).contiguous() for t in one]
        got = _xp_parse_launch(batch, 65536)
        # the plain parse on the host: a loop of 73,712 small steps
        want = xp_parse.xp_parse_ref(*(t.cpu() for t in one), 65536)
        _assert_equal(got, [w.expand(80, *w.shape[1:]) for w in want])
        assert (xp_parse.xp_parse.steps == 65536 // 32).all()


def test_xpress_decode_on_card_matches_cpu(dev):
    native = Native()
    rows, units = _xp_rows(native)
    streams, lens = [s for s, _ in rows], [n for _, n in rows]
    batch = xp.pack_units(streams, lens, 65536, dev)
    got = xp.decode_batch(*batch, 65536)
    _assert_equal(got, xp.decode_batch(*(t.cpu() for t in batch), 65536))
    out = tpucomp_torch.decompress_batch("xpress", streams[:len(units)],
                                         lens[:len(units)])
    assert out == units
    with pytest.raises(tpucomp_torch.DataError):
        tpucomp_torch.decompress_batch("xpress", streams[-3:], lens[-3:])


def test_xpress_encode_on_card_matches_cpu_and_round_trips(dev):
    native = Native()
    data = _encode_inputs()
    for W, units in ((4096, [data[i:i + 4096] for i in range(0, 20480, 4096)]
                      + [b"", b"q" * 4000]),
                     (65536, [data[:65536], data[:30000] * 2])):
        rows = np.zeros((len(units), W), np.uint8)
        for i, u in enumerate(units):
            rows[i, :len(u)] = np.frombuffer(u, np.uint8)
        ulen = torch.tensor([len(u) for u in units], dtype=torch.int32)
        args = torch.from_numpy(rows), ulen
        got = xp.encode_batch(*(t.to(dev) for t in args))
        _assert_equal(got, xp.encode_batch(*args))
        streams = tpucomp_torch.compress_batch("xpress", units, unit_size=W)
        assert tpucomp_torch.decompress_batch(
            "xpress", streams, [len(u) for u in units], unit_size=W) == units
        for s, u in zip(streams, units):
            assert native.xpress_decompress(s, len(u)) == u
    d = data[:40000]  # one unit of 64 KiB
    s = tpucomp_torch.compress("xpress", d)
    assert s == tpucomp_torch.compress("xpress", d, device="cpu")
    assert tpucomp_torch.decompress("xpress", s, len(d)) == d


def test_xpress_stream_encode_on_card_matches_cpu(dev, monkeypatch):
    """``compress`` over 64 KiB (one stream, 64 KiB lanes) on the card
    equals its CPU run and the committed vector; 8 KiB lanes in
    dispatches of 8 equal their CPU run and decode back."""
    from benchmarks.corpus import _synthetic

    native = Native()
    data = _synthetic(3 * 65536 + 4321)
    assert hashlib.sha256(data).hexdigest() == XP_STREAM_INPUT_SHA256
    s = tpucomp_torch.compress("xpress", data)
    assert s == tpucomp_torch.compress("xpress", data, device="cpu")
    assert hashlib.sha256(s).hexdigest() == XP_STREAM_SHA256
    assert native.xpress_decompress(s, len(data)) == data
    monkeypatch.setattr(xp, "ENCODE_BATCH_CAP", 1)
    small = data[:20 * 8192 + 1234]
    s = xp.compress_stream(small, 8192)
    assert s == xp.compress_stream(small, 8192, device="cpu")
    assert native.xpress_decompress(s, len(small)) == small


@pytest.mark.parametrize("K", [512, 16384, 65536])
def test_gather_rows_kernel_matches_plain(K, dev):
    """The shared-memory table (K = 512) and the read-only-cache path, with
    indices outside [0, K) and values over all 32 bits."""
    r = np.random.default_rng(K + 5)
    data = torch.from_numpy(r.integers(-(1 << 31), 1 << 31, (5, K),
                                       dtype=np.int64).astype(np.int32))
    idx = r.integers(0, K, (5, 9000)).astype(np.int32)
    idx[:, ::7] = r.choice([-1, K, K + 3, -(1 << 31), (1 << 31) - 1], 1286)
    idx = torch.from_numpy(idx)
    for nbits in (9, 20, 32):
        before = gather.gather_rows.launches
        got = gather.gather_rows(data.to(dev), idx.to(dev), nbits)
        assert gather.gather_rows.launches == before + 1
        _assert_equal([got], [gather.gather_rows_ref(data, idx, nbits)])


def test_xh_encode_on_card_matches_cpu_and_round_trips(dev):
    native = Native()
    data = _encode_inputs()
    W = 16384
    units = [data[:W], data[W:2 * W], bytes(W), data[:5000], b"", b"q"]
    rows = np.zeros((len(units), W), np.uint8)
    for i, u in enumerate(units):
        rows[i, :len(u)] = np.frombuffer(u, np.uint8)
    ulen = torch.tensor([len(u) for u in units], dtype=torch.int32)
    args = torch.from_numpy(rows), ulen
    before = gather.gather_rows.launches
    got = xh.encode_batch(*(t.to(dev) for t in args))
    assert gather.gather_rows.launches == before + 1
    _assert_equal(got, xh.encode_batch(*args))
    streams = tpucomp_torch.compress_batch("xpress_huff", units, unit_size=W)
    assert tpucomp_torch.decompress_batch(
        "xpress_huff", streams, [len(u) for u in units], unit_size=W) == units
    for s, u in zip(streams, units):
        assert not u or native.xh_decompress(s, len(u)) == u
    s = tpucomp_torch.compress("xpress_huff", data)
    assert s == tpucomp_torch.compress("xpress_huff", data, device="cpu")


# ---- the Huffman table kernel -----------------------------------------------

def _hold_tables(freqs, dev):
    """The kernel's (lengths, codes) of int32 [N, 512] ``freqs`` equal to
    the plain version's, in one launch."""
    before = huffman.huffman_tables.launches
    got = huffman.huffman_tables(freqs.to(dev))
    assert huffman.huffman_tables.launches == before + (freqs.shape[0] > 0)
    _assert_equal(got, huffman.huffman_tables_ref(freqs.cpu()))


@pytest.mark.parametrize("name", HUFF_CASES)
def test_huffman_tables_kernel_on_cases(name, dev):
    _hold_tables(huff_rows(name), dev)


@pytest.mark.parametrize("N", [0, 1, 3, 512, 546])
def test_huffman_tables_kernel_on_seeded_rows(N, dev):
    rows = _seeded(np.random.default_rng(2400 + N), N)
    _hold_tables(torch.from_numpy(rows.astype(np.int32)), dev)


def test_huffman_tables_kernel_beyond_the_bound(dev):
    """A row whose counts sum to 2^30 or more, the empty slot's cost, gets
    lengths and codes of -1; the rows beside it, one just below the
    bound and one with negative (unused) counts among them, are the plain
    version's."""
    near = huff_rows("near_2_21")[0]
    over = torch.zeros(huffman.NUM_SYMBOLS, dtype=torch.int32)
    over[:2] = 1 << 29
    below = over.clone()
    below[1] -= 1
    neg = huff_rows("zipf")[0].clone()
    neg[::5] = -5
    freqs = torch.stack([near, over, below, neg, huff_rows("zipf")[1] << 18])
    assert (freqs.long().sum(1) >= 1 << 30).tolist() == [
        False, True, False, False, True]
    got = huffman.huffman_tables(freqs.to(dev))
    torch.cuda.synchronize()
    for k in (1, 4):
        assert all((g[k] == -1).all() for g in got)
    keep = [0, 2, 3]
    _assert_equal([g[keep] for g in got],
                  huffman.huffman_tables_ref(freqs[keep]))


def _hiberfil_units(n, seed):
    """``n`` units of 64 KiB from a seeded hibernation-file-like mix:
    16 pages of 4 KiB a unit, each zeros (30%), code (20%: x86 idioms
    with random operands), heap (25%: 8-byte words, pointers of a few
    regions, small integers and zeros), text (15%) or random bytes
    (10%); uint8 [n, 65536]."""
    from benchmarks.corpus import _synthetic

    P = 4096
    r = np.random.default_rng(seed)
    text = np.frombuffer(_synthetic(1 << 20, seed), np.uint8)
    ops = [b"\x55", b"\x48\x89\xe5", b"\xc3", b"\x48\x83\xec", b"\xe8",
           b"\x48\x8b\x45", b"\x89\x45", b"\x0f\x84", b"\x31\xc0", b"\x90"]
    regions = (0x7FF000000000 + r.integers(0, 1 << 24, 8) * 4096).astype(
        np.uint64)
    m = 1 << 17
    operand = r.integers(0, 256, (m, 2), dtype=np.uint8)
    code = np.frombuffer(b"".join(
        ops[o] + operand[i, :w].tobytes() for i, (o, w) in enumerate(zip(
            r.integers(0, len(ops), m).tolist(),
            r.integers(0, 3, m).tolist()))), np.uint8)
    kinds = r.choice(5, n * 16, p=[0.30, 0.20, 0.25, 0.15, 0.10])
    pages = np.zeros((n * 16, P), np.uint8)
    for k, kind in enumerate(kinds):
        if kind == 1:
            at = r.integers(0, len(code) - P)
            pages[k] = code[at:at + P]
        elif kind == 2:
            w = r.integers(0, 3, P // 8)
            words = np.where(
                w == 0, regions[r.integers(0, 8, P // 8)]
                + (r.integers(0, 1 << 12, P // 8) * 16).astype(np.uint64),
                np.where(w == 1, r.integers(0, 256, P // 8), 0)
                .astype(np.uint64))
            pages[k] = words.astype("<u8").view(np.uint8)
        elif kind == 3:
            at = r.integers(0, len(text) - P)
            pages[k] = text[at:at + P]
        elif kind == 4:
            pages[k] = r.integers(0, 256, P, dtype=np.uint8)
    return torch.from_numpy(pages.reshape(n, 16 * P))


def test_huffman_tables_kernel_on_hiberfil_histograms(dev):
    """The histograms of a batch of 512 hibernation-file sets, made by the
    encoder's stages on the card, through the kernel and the plain
    version; then one traced ``encode_batch`` of 8 of the sets: the same
    stream bytes as on the CPU, one launch for all rows, no merge step
    issued from the host, and no host sync of the tables."""
    units = _hiberfil_units(512, 2400)
    x = units.to(dev)
    ulen = torch.full((512,), units.shape[1], dtype=torch.int32, device=dev)
    best_len, best_disp, use_match, okpos = xp.find_matches(
        x, ulen, max_disp=None)
    committed = commit.greedy_commit(use_match, best_len, okpos)
    sym = xh.symbols(x, best_len, best_disp, use_match, committed)
    freqs = common.histogram(sym, huffman.NUM_SYMBOLS)
    assert int((freqs > 0).sum(1).min()) >= 1
    _hold_tables(freqs.cpu(), dev)
    sub = units[::64].clone()
    sub[-1, 4096 * 3:] = 0
    sub_len = torch.tensor([units.shape[1]] * 7 + [4096 * 3],
                           dtype=torch.int32)

    def call():
        with stats.span("test.call", "call"):
            return xh.encode_batch(sub.to(dev), sub_len.to(dev))

    got, records = traced(call)
    _assert_equal(got, xh.encode_batch(sub, sub_len))
    n = totals(records)
    assert n["launches.huffman_tables"] == 1
    assert n["huffman.kernel_rows"] == sub.shape[0]
    assert n["huffman.merge_steps"] == 0
    assert "huffman.repair_rounds" not in n
    assert not {r.name for r in records} & {
        "huffman.merge_step", "huffman.repair_round", "sync.huffman_steps",
        "sync.huffman_repair"}


# ---- the one-shot XH decode: [history | block] rows of 131072 ---------------

BLOCK = xh.BLOCK


def _ten_blocks(native):
    """Ten blocks less 1234 bytes of repeated text (about 9 KB a block)
    by the native encoder: (data, stream, the blocks' starts).  The
    encoder is block-local, so its stream is its blocks' streams end to
    end; the Kraft scan finds 31 candidates, the ten starts among them."""
    data = (_xh_units()[0] * 140)[:10 * BLOCK - 1234]
    blocks = [native.xh_compress(data[k:k + BLOCK])
              for k in range(0, len(data), BLOCK)]
    stream = b"".join(blocks)
    assert stream == native.xh_compress(data)
    return data, stream, np.cumsum([0] + [len(b) for b in blocks[:-1]])


def _vector():
    """The committed cross-block stream (the oracle's, ``cross_block=True``)
    and its input, checked against the sha256 its CPU test pins, and its
    blocks' starts (its three Kraft candidates)."""
    from benchmarks.corpus import _synthetic

    data = _synthetic(3 * BLOCK)
    assert hashlib.sha256(data).hexdigest() == XH_VECTOR_INPUT_SHA256
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), XH_VECTOR), "rb") as f:
        stream = f.read()
    starts = xh._kraft_candidates(np.frombuffer(stream, np.uint8))
    assert len(starts) == 3
    return data, stream, starts


def _oneshot_rows(native):
    """Rows of the history decode, each a slice from a block start to up
    to ``max_payload(65536)`` bytes on (the blocks after it follow):
    (stream slice, out_len, hist_len).  The ten-block stream's first
    three blocks and the vector's three at a full history reach, the
    vector's later blocks also with none (their matches reach before the
    block: err), and 64 KiB of random bytes (tier 3) stopped at out_len
    6000, mid-body."""
    MP = xh.max_payload(BLOCK)
    rows = []
    for _, s, starts in (_ten_blocks(native), _vector()):
        for o in starts[:3].tolist():
            rows.append((s[o:o + MP], BLOCK, BLOCK))
            if o:
                rows.append((s[o:o + MP], BLOCK, 0))
    r = np.random.default_rng(30)
    noise = native.xh_compress(r.integers(0, 256, BLOCK, dtype=np.uint8)
                               .tobytes())
    rows.append((noise, 6000, BLOCK))
    return rows


def test_xh_parse_kernel_with_history_and_span(dev):
    """The parse with hist_len and the span against xh_parse_ref: every
    plane equal, the span on the rows without err."""
    rows = _oneshot_rows(Native())
    batch = xh.pack_units([r[0] for r in rows], [r[1] for r in rows], BLOCK,
                          dev)
    args = xh.parse_inputs(*batch)
    hl = torch.tensor([r[2] for r in rows], dtype=torch.int32)
    cpu = [a.cpu() for a in args]
    want = xh_parse.xh_parse_ref(*cpu, BLOCK, hl, True)
    before = xh_parse.xh_parse.launches
    got = xh_parse.xh_parse(*args, BLOCK, hist_len=hl.to(dev), want_span=True)
    assert xh_parse.xh_parse.launches == before + 1
    _assert_equal(got[:4], want[:4])
    ok = (want[3] == 0) & (want[2] >= batch[2].cpu())
    assert torch.equal(got[4].cpu()[ok], want[4][ok])
    assert int(ok.sum()) >= 7 and int((~ok).sum()) >= 1
    assert int(batch[3][-1]) == 3
    print(f"xh_parse rounds on the one-shot rows: "
          f"{xh_parse.xh_parse.rounds.cpu().tolist()}")


def _history_states(dev):
    """The near walk's inputs on the [history | block] rows of every block
    of the ten-block stream and of the vector, each with the block before
    it as history (as a fixpoint pass decodes them), on the card."""
    native = Native()
    rows = []
    for data, s, starts in (_ten_blocks(native), _vector()):
        for k, o in enumerate(starts.tolist()):
            before = data[max(0, (k - 1) * BLOCK):k * BLOCK]
            rows.append((s[o:o + xh.max_payload(BLOCK)],
                         min(BLOCK, len(data) - k * BLOCK), before))
    batch = xh.pack_units([r[0] for r in rows], [r[1] for r in rows], BLOCK,
                          dev)
    hist = np.zeros((len(rows), BLOCK), np.uint8)
    for i, (_, _, h) in enumerate(rows):
        hist[i, BLOCK - len(h):] = np.frombuffer(h, np.uint8)
    hist = torch.from_numpy(hist).to(dev)
    hl = torch.full((len(rows),), BLOCK, dtype=torch.int32, device=dev)
    rec_pos, rec_val, _, err = xh.parse_batch(*batch, BLOCK, hl)
    assert not bool(err.any())
    vpack, tokpos, _ = fill.fill_records_delta2(rec_pos, rec_val, BLOCK,
                                                BLOCK)
    is_copy, disp, litv = xh.near_inputs(vpack, tokpos)
    z = torch.zeros_like(hist, dtype=torch.int32)
    planes = (torch.cat([z.bool(), is_copy], 1), torch.cat([z, disp], 1),
              torch.cat([hist.int(), litv], 1))
    return planes, rows


def test_wide_kernels_on_history_rows(dev):
    """The near walk, the 4 KiB level and the full-row level at [N,
    131072] on real [history | block] rows against their plain versions;
    the rows are swept, and the bytes past the history are the input."""
    planes, rows = _history_states(dev)
    before = resolve.resolve_near.launches
    near = resolve.resolve_near(*planes)
    assert resolve.resolve_near.launches == before + 1
    _assert_equal([near], [resolve.resolve_near_ref(*planes)])
    seg_args = (near, common.SEG_LEVEL, common.SEG_LEVEL_CAP, False)
    seg = gather.far_level(*seg_args)
    _assert_equal([seg], [gather.far_level_ref(*seg_args)])
    assert not _hold_far_row(seg).any()
    out = gather.far_row(seg).to(torch.uint8).cpu().numpy()
    ten = _ten_blocks(Native())[0]
    for k in range(3):
        assert out[k, BLOCK:].tobytes() == ten[k * BLOCK:(k + 1) * BLOCK]


def test_xh_oneshot_decode_on_card(dev):
    """decompress of the ten-block stream (the speculative path: three
    batch decodes) equal to its CPU run and the input, and of the vector
    (fixpoint passes with the true history) equal to its input; a stream
    cut short raises DataError."""
    native = Native()
    data, s, _ = _ten_blocks(native)
    got, records = traced(lambda: tpucomp_torch.decompress(
        "xpress_huff", s, len(data)))
    assert got == data and totals(records)["xh.batch_decodes"] == 3
    assert tpucomp_torch.decompress("xpress_huff", s, len(data),
                                    device="cpu") == data
    data, s, _ = _vector()
    got, records = traced(lambda: tpucomp_torch.decompress(
        "xpress_huff", s, len(data)))
    assert got == data
    assert totals(records)["xh.batch_decodes"] >= 3
    with pytest.raises(tpucomp_torch.DataError):
        tpucomp_torch.decompress("xpress_huff", s[:len(s) // 2], len(data))

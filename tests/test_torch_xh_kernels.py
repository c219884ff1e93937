"""tpucomp_torch's Xpress Huffman decode stages after the parse, in their
plain PyTorch versions on the CPU, against tpucomp's stage by stage: the
fill, the near walk, each far level and the probes, at U = 16384 (every
level runs: 512 < 4096 < U, and U > 8192 takes tpucomp's pair gather).

tpucomp's Pallas kernels run in interpret mode, as its own tests run
them.  The same seeded inputs go through both packages as numpy arrays.
Every value is an integer, so the tolerance is exact equality.
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_corpus
from tpucomp import _native
from tpucomp.codecs import xpress_huff as t_xh
from tpucomp.kernels import common as t_common
from tpucomp.kernels import fill_pallas, huffman as t_huff
from tpucomp.kernels import resolve_pallas, xh_pallas
from tpucomp_torch.codecs import xpress_huff as xh
from tpucomp_torch.kernels import common, fill, gather, huffman, xh_parse

U = 16384
FAR_TAG = common.FAR_TAG


@functools.lru_cache(maxsize=None)
def _units():
    """Short units in U-wide rows (the plain parse loops once per body
    byte): text, a periodic run, a resolved archive unit and zeros."""
    rng = random.Random(0xBEEF)
    text = make_corpus(rng, 8192)
    units = [text, (b"abcabd" * 2000)[:9000] + text[:3000],
             text[::-1][:7000], bytes(U)]
    streams = [_native.xh_compress(u) for u in units[:2]] + [
        _native.xh_compress_resolved(units[2]), _native.xh_compress(units[3])]
    return streams, [len(u) for u in units]


@pytest.mark.parametrize("empty", [common.SENT_KEY, -1])
def test_fill_matches_tpucomp_on_random_records(empty):
    """Non-decreasing positions with adjacent repeats (the last wins),
    empty slots that never split a run, out-of-range positions, values
    past 22 bits, and R both below and above U."""
    r = np.random.default_rng(12)
    W = 1024
    for R in (700, 1500):
        N = 5
        pos = np.sort(r.integers(-3, W + 40, (N, R)), axis=1).astype(np.int32)
        first = np.ones((N, R), bool)
        first[:, 1:] = pos[:, 1:] != pos[:, :-1]
        pos[first & (r.random((N, R)) < 0.3)] = empty
        pos[0] = empty  # a row with no record at all
        val = r.integers(0, 1 << 21, (N, R)).astype(np.int32)
        val[1] |= 1 << 23
        for keep in (None, 200):
            want = [np.asarray(a) for a in t_common.fill_records_delta2(
                jnp.asarray(pos), jnp.asarray(val), W, keep=keep)]
            got = fill.fill_records_delta2_ref(torch.from_numpy(pos),
                                               torch.from_numpy(val), W, keep)
            np.testing.assert_array_equal(got[2].numpy(), want[2])
            ok = want[2] == 0
            for g, w in zip(got[:2], want[:2]):
                np.testing.assert_array_equal(g.numpy()[ok], w[ok])
            if keep:
                assert want[2].any() and ok.any()


@functools.lru_cache(maxsize=None)
def _near_inputs():
    """(is_copy, disp, litv) [N, U] as the port's decode tail builds them
    (fold included) from the units' records."""
    batch = xh.pack_units(*_units(), U, "cpu")
    rec_pos, rec_val, _, err = xh.parse_batch(*batch, U)
    assert not err.any()
    vpack, tokpos, _ = fill.fill_records_delta2_ref(rec_pos, rec_val, U)
    return tuple(t.numpy() for t in xh.near_inputs(vpack, tokpos))


def test_near_walk_matches_pallas(monkeypatch):
    is_copy, disp, litv = _near_inputs()
    # the array tpucomp hands to the far rounds is the near walk's output
    monkeypatch.setattr(resolve_pallas, "_far_rounds",
                        lambda out, *a, **k: out)
    want = resolve_pallas.resolve_copies(
        jnp.asarray(is_copy), jnp.asarray(disp), jnp.asarray(litv),
        interpret=True)
    got = xh.resolve_near(torch.from_numpy(is_copy), torch.from_numpy(disp),
                          torch.from_numpy(litv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tagged = (got.numpy() & FAR_TAG) != 0
    assert tagged.any() and (got.numpy()[tagged] & (FAR_TAG - 1)).max() > 4096


def _far_inputs():
    """Post-near-walk states [N, U]: the parsed rows', and seeded chains
    within and across 4 KiB segments, cycles, and sources outside the
    row or past 17 bits."""
    parsed = xh.resolve_near(*(torch.from_numpy(a)
                               for a in _near_inputs())).numpy()
    r = np.random.default_rng(5)
    x = r.integers(0, 256, (4, U)).astype(np.int32)
    tag = r.random((4, U)) < 0.5
    src = np.where(r.random((4, U)) < 0.5, r.integers(0, 4096, (4, U)),
                   r.integers(0, U, (4, U)))
    x[tag] = FAR_TAG | src[tag]
    x[1, 100], x[1, 200] = FAR_TAG | 200, FAR_TAG | 100  # cycle
    x[1, 5000], x[1, 9000] = FAR_TAG | 9000, FAR_TAG | 5000  # across
    x[2, 7] = FAR_TAG | (U + 9)  # outside the row
    x[2, 8] = FAR_TAG | (1 << 17) | 5  # past 17 bits
    x[2, 9] = FAR_TAG | (1 << 20) | 77
    x[3, 4096:U] = FAR_TAG | np.arange(4095, U - 1)  # one long chain
    x[3, 10:4000] = FAR_TAG | (np.arange(10, 4000) + 8192)  # adopted
    return np.concatenate([parsed, x])


def test_segment_level_matches_tpucomp(monkeypatch):
    monkeypatch.setenv("TPUCOMP_GATHER_PALLAS", "interpret")
    x = _far_inputs()
    want = t_common._far_level_segmented(jnp.asarray(x), U, 4096, cap=6,
                                         interpret=True)
    got = gather.far_level_ref(torch.from_numpy(x), common.SEG_LEVEL,
                               common.SEG_LEVEL_CAP, zero=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ((got.numpy() & FAR_TAG) != 0).any()  # tags left for later


def test_full_row_level_matches_tpucomp(monkeypatch):
    monkeypatch.setenv("TPUCOMP_GATHER_PALLAS", "interpret")
    x = _far_inputs()
    seg = np.asarray(t_common._far_level_segmented(
        jnp.asarray(x), U, U, interpret=True))
    want = np.where((seg & FAR_TAG) != 0, 0, seg)
    got = gather.far_row_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_probe_rounds_match_tpucomp(monkeypatch):
    """The probes alone: tpucomp's _far_rounds(fast=True) with its levels
    skipped (min_hop past 4096, the full-row level replaced by identity),
    so only the probes and the final zeroing of tags run."""
    monkeypatch.setenv("TPUCOMP_GATHER_PALLAS", "interpret")
    x = _far_inputs()
    seg = gather.far_level_ref(torch.from_numpy(x), common.SEG_LEVEL,
                               common.SEG_LEVEL_CAP, zero=False)
    monkeypatch.setattr(t_common, "_far_level_segmented",
                        lambda out, *a, **k: out)
    want = np.asarray(t_common._far_rounds(jnp.asarray(seg.numpy()), U, U,
                                           fast=True, interpret=True))
    got = gather.far_probe_ref(seg).numpy()
    changed = got != seg.numpy()
    got = np.where((got & FAR_TAG) != 0, 0, got)
    np.testing.assert_array_equal(got, want)
    assert changed.any()


@pytest.mark.parametrize("fast", [False, True])
def test_far_rounds_match_tpucomp(fast, monkeypatch):
    monkeypatch.setenv("TPUCOMP_GATHER_PALLAS", "interpret")
    x = _far_inputs()
    want = t_common._far_rounds(jnp.asarray(x), U, resolve_pallas.SEG,
                                fast=fast, interpret=True)
    got = common.far_rounds(torch.from_numpy(x), U, resolve_pallas.SEG, fast)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class _CountingLax:
    """jax.lax with while_loop run eagerly, counting its rounds."""

    def __init__(self):
        self.rounds = 0

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    def while_loop(self, cond, body, state):
        while bool(cond(state)):
            state = body(state)
            self.rounds += 1
        return state


@pytest.mark.parametrize("S", [4096, 65536])
def test_level_caps_match_tpucomp(S, monkeypatch):
    """A cycle never resolves, so tpucomp runs every round of a level: 6
    at the 4 KiB level, 19 at the 64 KiB full row."""
    width = 65536
    x = np.zeros((1, width), np.int32)
    x[0, 10], x[0, 20] = FAR_TAG | 20, FAR_TAG | 10
    counting = _CountingLax()
    monkeypatch.setattr(t_common, "lax", counting)
    # the fetch itself does not matter here: a plain gather keeps it cheap
    monkeypatch.setattr(t_common, "_gather18", lambda t, i, interpret=False:
                        jnp.take_along_axis(t, i, axis=1) & 0x3FFFF)
    cap = common.SEG_LEVEL_CAP if S == 4096 else None
    t_common._far_level_segmented(jnp.asarray(x), width, S, cap=cap)
    want = common.SEG_LEVEL_CAP if S == 4096 else common.level_cap(S)
    assert counting.rounds == want == (6 if S == 4096 else 19)


def test_constants_match_tpucomp():
    assert xh.BLOCK == t_xh.BLOCK
    assert xh.NUM_SYMBOLS == t_xh.NUM_SYMBOLS == huffman.NUM_SYMBOLS
    assert xh._BUCKET_MCL == t_xh._BUCKET_MCL
    assert xh_parse.COPY_BIT == t_xh._COPY_BIT == xh_pallas._COPY_BIT
    assert xh_parse.MIN_MATCH == t_xh.MIN_MATCH == xh_pallas.MIN_MATCH
    assert xh_parse.SENT == xh_pallas.SENT
    assert huffman.MAX_CODE_LEN == t_huff.MAX_CODE_LEN
    assert common.ARCHIVE_PROBE_BUDGET == t_common.ARCHIVE_PROBE_BUDGET
    assert fill.V_RING == fill_pallas.V_RING and fill.P_RING == fill_pallas.P_RING
    for u in (512, 4096, 65536):
        assert xh.max_payload(u) == t_xh.max_payload(u)
    for mcl in range(0, 17):
        assert xh._substeps_for(mcl) == t_xh._substeps_for(mcl)
    streams = _units()[0]
    assert [xh._min_code_len([s]) for s in streams] == \
        [t_xh._min_code_len([s]) for s in streams]
    assert xh._min_code_len(streams) == t_xh._min_code_len(streams)


def test_new_wrappers_take_plain_version_on_cpu_and_count_no_launch():
    fns = [xh_parse.xh_parse, fill.fill_records_delta2, gather.far_level,
           gather.far_row, gather.far_probe]
    before = [f.launches for f in fns]
    out, err = xh.decode_batch(*xh.pack_units(*_units(), U, "cpu"), U,
                               fast_resolve=True)
    assert not err.any()
    assert [f.launches for f in fns] == before


def test_new_wrappers_raise_on_other_devices():
    meta = torch.zeros((2, U), dtype=torch.int32, device="meta")
    for call in (lambda: gather.far_row(meta), lambda: gather.far_probe(meta),
                 lambda: fill.fill_records_delta2(meta, meta, U)):
        with pytest.raises(ValueError, match="meta"):
            call()
    cpu = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="several devices"):
        xh_parse.xh_parse(torch.zeros((2, 8), dtype=torch.uint8), cpu[:, 0],
                          cpu[:, 0], cpu[:, 0], cpu, meta[:, :16],
                          torch.zeros((2, 512), dtype=torch.int32), U)

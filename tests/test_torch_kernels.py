"""tpucomp_torch's kernels, in their plain PyTorch versions on the CPU,
against tpucomp's Pallas kernels in interpret mode (and its XLA pieces).

The same seeded inputs go through both packages as numpy arrays.  Every
value is an integer, so the tolerance is exact equality everywhere.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_corpus
from tpucomp import _native
from tpucomp.codecs import lznt1 as t_lz
from tpucomp.kernels import common as t_common
from tpucomp.kernels import gather_pallas, lznt1_pallas, resolve_pallas
from tpucomp.oracle import lznt1 as oracle
from tpucomp_torch.codecs import lznt1 as lz
from tpucomp_torch.kernels import _build, common, gather, lznt1_parse, resolve

P = t_lz.PAYLOAD_PAD
U = t_lz.CHUNK
N_ROWS = 16  # one batch shape: Pallas interpret compiles once per shape


def _chunks_of(stream):
    payloads, comps = t_lz.split_stream(stream)
    return list(zip(payloads, comps))


def _batch(chunks):
    """(payload bytes, is_comp) pairs -> the numpy batch tpucomp takes,
    padded to N_ROWS rows."""
    assert len(chunks) <= N_ROWS
    payload = np.zeros((N_ROWS, P), np.int32)
    plen = np.zeros(N_ROWS, np.int32)
    is_comp = np.zeros(N_ROWS, bool)
    for k, (pl, cp) in enumerate(chunks):
        payload[k, :len(pl)] = np.frombuffer(pl, np.uint8)
        plen[k] = len(pl)
        is_comp[k] = cp
    return payload, plen, is_comp


def _malformed_chunks(rng):
    r = np.random.default_rng(7)
    real = _chunks_of(_native.lznt1_compress(make_corpus(rng, 3 * U)))
    cut = [(pl[:len(pl) * f // 5], True) for f, (pl, _) in
           zip((1, 2, 3), real)]  # compressed chunks cut short
    return cut + [
        (bytes([0x01, 0x00, 0x00]), True),  # copy at p=0: disp 1 > 0
        (bytes([0x02, 0x41, 0x00, 0x40]), True),  # disp 5 at p=1
        (bytes([0x01, 0x07]), True),  # ends after a copy's lo byte
        (bytes([0x00]) + b"abc", True),  # ends after its literals: fine
        (b"", True),
        (bytes([0x00, 0x41, 0x00]), False),  # stored raw, short
    ] + [(r.integers(0, 256, n, dtype=np.uint8).tobytes(), True)
         for n in (5, 300, 4096)]  # random bytes parsed as tokens


def _parse_cases():
    rng = random.Random(0xC0FFEE)
    data = make_corpus(rng, 5 * U + 1234)
    incompressible = bytes(rng.randrange(256) for _ in range(2 * U))
    return {
        "oracle": _chunks_of(oracle.compress(data)),
        "native": _chunks_of(_native.lznt1_compress(data + b"ab" * 3000)),
        "raw": _chunks_of(_native.lznt1_compress(incompressible + data[:U])),
        "malformed": _malformed_chunks(rng),
    }


PARSE_CASES = _parse_cases()


def _port_parse(payload, plen, is_comp):
    return lznt1_parse.lznt1_parse(
        *lz.batch_from_numpy(payload, plen, is_comp, device="cpu"))


def _tpu_parse(payload, plen, is_comp):
    out = lznt1_pallas.parse_records(
        jnp.asarray(payload), jnp.asarray(plen), jnp.asarray(is_comp), U,
        interpret=True)
    return [np.array(a) for a in out]  # writable: torch.from_numpy shares


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_parse_matches_pallas(case):
    batch = _batch(PARSE_CASES[case])
    want_pos, want_val, want_p, want_err = _tpu_parse(*batch)
    got_pos, got_val, got_p, got_err = (t.numpy() for t in _port_parse(*batch))
    assert (want_pos[:, P:] == lznt1_parse.SENT).all()
    np.testing.assert_array_equal(got_pos, want_pos[:, :P])
    np.testing.assert_array_equal(got_val, want_val[:, :P])
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_err, want_err)
    if case == "malformed":
        assert got_err.sum() >= 3
    else:
        assert not got_err.any()


def test_fill_matches_tpucomp_on_parsed_records():
    batch = _batch(PARSE_CASES["native"])
    rec_pos, rec_val, _, _ = _tpu_parse(*batch)
    want, _ = t_common.fill_records_delta(
        jnp.asarray(rec_pos), jnp.asarray(rec_val), U)
    got = common.fill_records_delta(
        torch.from_numpy(rec_pos), torch.from_numpy(rec_val), U)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("empty", [common.SENT_KEY, -1])
def test_fill_matches_tpucomp_on_random_records(empty):
    """Non-decreasing positions with adjacent repeats (the last wins, as
    in tpucomp's carry-replicated XLA scan records), empty slots keyed
    SENT or -1 that never split a run, and out-of-range positions."""
    r = np.random.default_rng(11)
    N, R, W = 6, 700, 512
    pos = np.sort(r.integers(-3, W + 40, (N, R)), axis=1).astype(np.int32)
    first_of_run = np.ones((N, R), bool)
    first_of_run[:, 1:] = pos[:, 1:] != pos[:, :-1]
    pos[first_of_run & (r.random((N, R)) < 0.3)] = empty
    pos[0] = empty  # a row with no record at all
    val = r.integers(0, 1 << 21, (N, R)).astype(np.int32)
    want, _ = t_common.fill_records_delta(jnp.asarray(pos), jnp.asarray(val), W)
    got = common.fill_records_delta(torch.from_numpy(pos),
                                    torch.from_numpy(val), W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _near_inputs(kind):
    """Dense (is_copy, disp, litv) [4, U] arrays: from parsed chunks, or
    seeded random ones that cross every near/far boundary."""
    if kind == "parsed":
        batch = _batch(PARSE_CASES["native"] + PARSE_CASES["malformed"][:4])
        rec_pos, rec_val, _, _ = _tpu_parse(*batch)
        vpack = np.asarray(t_common.fill_records_delta(
            jnp.asarray(rec_pos), jnp.asarray(rec_val), U)[0])[:8]
        is_copy = (vpack & lznt1_parse.COPY_BIT) != 0
        disp = vpack & (lznt1_parse.COPY_BIT - 1)
        return is_copy, disp, np.where(is_copy, 0, vpack & 0xFF)
    r = np.random.default_rng(3)
    shape = (4, U)
    is_copy = r.random(shape) < 0.6
    disp = np.where(r.random(shape) < 0.7, r.integers(1, 40, shape),
                    r.integers(1, 5000, shape)).astype(np.int32)
    disp[0, ::97] = 0x30000  # clamped to 17 bits
    return is_copy, disp, r.integers(0, 256, shape).astype(np.int32)


@pytest.mark.parametrize("kind", ["parsed", "random"])
def test_resolve_near_matches_pallas(kind, monkeypatch):
    is_copy, disp, litv = _near_inputs(kind)
    # the array tpucomp hands to the far rounds is the near walk's output
    monkeypatch.setattr(resolve_pallas, "_far_rounds",
                        lambda out, *a, **k: out)
    want = resolve_pallas.resolve_copies(
        jnp.asarray(is_copy), jnp.asarray(disp), jnp.asarray(litv),
        interpret=True)
    got = resolve.resolve_near(torch.from_numpy(is_copy),
                               torch.from_numpy(disp), torch.from_numpy(litv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ((got & common.FAR_TAG) != 0).any()


def _far_inputs(kind):
    """Post-near-walk states [N, U]: real ones, or seeded chains, cycles
    and sources outside the row."""
    if kind == "parsed":
        is_copy, disp, litv = _near_inputs("parsed")
        return resolve.resolve_near(torch.from_numpy(is_copy),
                                    torch.from_numpy(disp),
                                    torch.from_numpy(litv)).numpy()
    r = np.random.default_rng(5)
    x = r.integers(0, 256, (3, U)).astype(np.int32)
    tag = r.random((3, U)) < 0.5
    x[tag] = common.FAR_TAG | r.integers(0, U, tag.sum())
    x[1, 100], x[1, 200] = common.FAR_TAG | 200, common.FAR_TAG | 100  # cycle
    x[2, 7] = common.FAR_TAG | 9000  # outside the row: never chased
    x[2, 8:4000] = common.FAR_TAG | np.arange(7, 3999)  # one long chain
    return x


@pytest.mark.parametrize("kind", ["parsed", "random"])
def test_far_level_matches_tpucomp(kind, monkeypatch):
    monkeypatch.setenv("TPUCOMP_GATHER_PALLAS", "interpret")
    x = _far_inputs(kind)
    seg = np.asarray(t_common._far_level_segmented(
        jnp.asarray(x), U, U, interpret=True))
    want = np.where((seg & common.FAR_TAG) != 0, 0, seg)
    got = gather.far_level(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    # the same as the whole of tpucomp's _far_rounds on LZNT1's path
    full = t_common._far_rounds(jnp.asarray(x), U, resolve_pallas.SEG,
                                interpret=True)
    np.testing.assert_array_equal(got, np.asarray(full))


def test_gather18_matches_pallas_with_out_of_range():
    r = np.random.default_rng(9)
    table = r.integers(0, 1 << 20, (2, U)).astype(np.int32)  # > 18 bits too
    idx = r.integers(-50, U + 50, (2, U)).astype(np.int32)
    want = gather_pallas.gather18_stacked(jnp.asarray(table), jnp.asarray(idx),
                                          interpret=True)
    got = gather.gather18_ref(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[(idx < 0) | (idx >= U)] == 0).all()


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


def test_constants_match_tpucomp(monkeypatch):
    assert lz.CHUNK == t_lz.CHUNK
    assert lz.PAYLOAD_PAD == t_lz.PAYLOAD_PAD
    assert lz.MAX_PAYLOAD == t_lz.MAX_PAYLOAD
    assert common.FAR_TAG == t_common.FAR_TAG
    assert common.SENT_KEY == t_common.SENT_KEY == lznt1_pallas.SENT
    assert lznt1_parse.SENT == lznt1_pallas.SENT
    assert lznt1_parse.COPY_BIT == t_lz._COPY_BIT
    assert resolve.SEG == resolve_pallas.SEG
    # the round cap: a cycle never resolves, so tpucomp runs every round
    x = np.zeros((1, U), np.int32)
    x[0, 10], x[0, 20] = common.FAR_TAG | 20, common.FAR_TAG | 10
    counting = _CountingLax()
    monkeypatch.setattr(t_common, "lax", counting)
    t_common._far_level_segmented(jnp.asarray(x), U, U)
    assert counting.rounds == common.FAR_MAX_ROUNDS == 15


def test_wrappers_take_plain_version_on_cpu_and_count_no_launch():
    batch = lz.batch_from_numpy(*_batch(PARSE_CASES["native"]), device="cpu")
    before = [lznt1_parse.lznt1_parse.launches, resolve.resolve_near.launches,
              gather.far_level.launches]
    lz.decode_batch(*batch)
    assert [lznt1_parse.lznt1_parse.launches, resolve.resolve_near.launches,
            gather.far_level.launches] == before


def test_wrappers_raise_on_other_devices():
    meta = torch.zeros((2, U), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        gather.far_level(meta)
    with pytest.raises(ValueError, match="several devices"):
        resolve.resolve_near(torch.zeros((2, U), dtype=torch.bool), meta,
                             meta)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        pytest.skip("this machine has /usr/local/cuda/bin/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_shared_library_keyed_by_flags_and_sources(monkeypatch, tmp_path):
    """A library is reused only while its flags and sources are unchanged;
    a compiler error raises.  Built with the host C compiler."""
    import shutil

    cc = shutil.which("cc") or shutil.which("gcc")
    assert cc, "no C compiler on PATH"
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "k.c"
    src.write_text("int k(void) { return 1; }\n")
    flags = ["-O1", "-fPIC", "-shared"]
    path, log = _build.shared_library(cc, flags, [str(src)], "k")
    assert os.path.exists(path)
    assert _build.shared_library(cc, flags, [str(src)], "k") == (path, "")
    path_o2, _ = _build.shared_library(cc, ["-O2", *flags[1:]], [str(src)],
                                       "k")
    src.write_text("int k(void) { return 2; }\n")
    path_src, _ = _build.shared_library(cc, flags, [str(src)], "k")
    assert len({path, path_o2, path_src}) == 3
    src.write_text("int k(void) { return }\n")
    with pytest.raises(RuntimeError, match="failed"):
        _build.shared_library(cc, flags, [str(src)], "k")
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        os.path.basename(p) for p in (path, path_o2, path_src))

"""tpucomp_torch's plain Xpress single-stream encoder (``compress_stream``)
on the CPU against tpucomp's ``codecs.xpress.compress_stream``, at 8 KiB
lanes and dispatches of 8 lanes in both packages (tpucomp's
``encode_batch_cap`` 1, the port's ``ENCODE_BATCH_CAP`` 1): the bytes of
every stream, byte for byte, each decoded back through tpucomp's oracle
and the native C decoder; one dispatch through the port's chunk function
against tpucomp's jitted ``_encode_stream_impl`` in all nine outputs; the
two lane scans against numpy loops; the unit-size refusals.  tpucomp runs
on its XLA path, as its own tests run it on the CPU, at one compile shape
([8, 8192] rows).  The 64 KiB lanes are in
``test_torch_xpress_stream_wide.py``.  Every value is a byte or an
integer: the tolerance is exact equality.
"""

import random

import numpy as np
import pytest
import torch

import tpucomp.config as t_config
from benchmarks.corpus import _synthetic
from tpucomp import _native
from tpucomp.codecs import xpress as t_xp
from tpucomp.oracle import xpress as oracle
from tpucomp_torch.codecs import xpress as xp
from tpucomp_torch.errors import ArgError
from tpucomp_torch.kernels.commit import greedy_commit
from _threads import _one_thread  # noqa: F401

LANE = 8192


@pytest.fixture(autouse=True)
def _eight_lane_dispatches(monkeypatch):
    for var in ("TPUCOMP_PALLAS", "TPUCOMP_RUNS_PALLAS",
                "TPUCOMP_SORT_PALLAS", "TPUCOMP_COMMIT_PALLAS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(t_config.DEFAULT, "encode_batch_cap", 1)
    monkeypatch.setattr(xp, "ENCODE_BATCH_CAP", 1)
    assert xp.stream_lanes(LANE) == 8


def port_stream(data, unit_size=LANE):
    return xp.compress_stream(data, unit_size, device="cpu")


def check_stream(data) -> bytes:
    """The port's stream of ``data`` equals tpucomp's and decodes back
    through the oracle and the native C decoder."""
    got = port_stream(data)
    assert got == t_xp.compress_stream(data, unit_size=LANE)
    assert oracle.decompress(got, len(data)) == data
    assert _native.xpress_decompress(got, len(data)) == data
    return got


def nibble_lanes(n_lanes, users, seed):
    """``n_lanes`` lanes of seeded random bytes (no match of 10 bytes or
    more by chance); lane i repeats a 30-byte string of its own
    ``users.get(i, 0)`` times, 4 KiB apart: each repeat is one match
    whose length takes a shared nibble."""
    r = np.random.default_rng(seed)
    lanes = r.integers(0, 256, (n_lanes, LANE), dtype=np.uint8)
    for i, k in users.items():
        s = r.integers(0, 256, 30, dtype=np.uint8)
        for j in range(k + 1):
            lanes[i, 100 + 2600 * j:130 + 2600 * j] = s
    return lanes.tobytes()


def lane_nibble_users(data, n_lanes):
    """Nibble users of each of the first ``n_lanes`` lanes of ``data``,
    from the port's finder and walk on one dispatch."""
    units = torch.from_numpy(np.frombuffer(data[:n_lanes * LANE], np.uint8)
                             .reshape(n_lanes, LANE).copy())
    ulen = torch.full((n_lanes,), LANE, dtype=torch.int32)
    bl, _, use, ok = xp.stream_find_matches(
        units, ulen, torch.zeros(xp.WINDOW, dtype=torch.uint8), 0)
    users = greedy_commit(use, bl, ok) & use & (bl - xp.MIN_MATCH >= 7)
    return users.sum(1).tolist()


def zero_run_start():
    return bytes(5000) + _synthetic(4 * LANE)


def skipped_lanes():
    # lane 0 ends on an opener whose partner is lane 2's first nibble
    # (lane 1 has none); lane 7, the first dispatch's last, ends on an
    # opener that the third dispatch's lane 16 fills (lanes 8-15 none)
    return nibble_lanes(17, {0: 1, 2: 1, 7: 1, 16: 3}, seed=5)


INPUTS = {
    "three_dispatches": lambda: _synthetic(20 * LANE + 1234),
    "zero_run_start": zero_run_start,
    "skipped_lanes": skipped_lanes,
    "one_byte_last_lane": lambda: _synthetic(16 * LANE + 1),
    "whole_lanes": lambda: _synthetic(16 * LANE),
    "ab": lambda: b"ab" * 40000,
}


@pytest.mark.parametrize("name", list(INPUTS))
def test_stream_matches_tpucomp(name):
    check_stream(INPUTS[name]())


def test_dangling_nibbles_skip_lanes_and_dispatches():
    """The skipped-lanes input has the nibble users it was built for, so
    both scans and the host's pending nibble are exercised."""
    data = skipped_lanes()
    assert lane_nibble_users(data, 8) == [1, 0, 1, 0, 0, 0, 0, 1]
    assert lane_nibble_users(data[16 * LANE:], 1) == [3]
    check_stream(data[:8 * LANE])  # one dispatch, no pending nibble


def test_bytes_do_not_depend_on_the_dispatch(monkeypatch):
    data = _synthetic(20 * LANE + 1234) + skipped_lanes()
    eight = port_stream(data)
    monkeypatch.setattr(xp, "ENCODE_BATCH_CAP", 128)  # 1024 lanes: one
    assert xp.stream_lanes(LANE) == 1024
    assert port_stream(data) == eight
    assert _native.xpress_decompress(eight, len(data)) == data


def test_chunk_function_matches_encode_stream_impl():
    """One dispatch over a seeded history (h0v 1), 19 tokens into a flag
    group (t0) and after an odd count of nibble users (k0): all nine
    outputs equal tpucomp's jitted ``_encode_stream_impl``."""
    import jax.numpy as jnp

    text = _synthetic(9 * LANE)
    hist = np.frombuffer(text[:xp.WINDOW], np.uint8)
    units = np.zeros((8, LANE), np.uint8)
    units.reshape(-1)[:7 * LANE + 3000] = np.frombuffer(
        text[xp.WINDOW:xp.WINDOW + 7 * LANE + 3000], np.uint8)
    ulen = np.array([LANE] * 7 + [3000], np.int32)
    t0, k0, h0v = 19, 1, 1
    got = xp.encode_stream_chunk(
        torch.from_numpy(units), torch.from_numpy(ulen),
        torch.from_numpy(hist.copy()), h0v, t0, k0)
    want = t_xp._senc_for(LANE)(
        jnp.asarray(units, jnp.int32), jnp.asarray(ulen),
        jnp.asarray(hist, jnp.int32), jnp.int32(h0v), jnp.int32(t0),
        jnp.int32(k0))
    names = ("payload", "plen", "Ttot", "Ktot", "head0", "lastf", "dangp",
             "fu_val", "fu_has")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy().astype(np.int64), np.asarray(w).astype(np.int64)
        if name == "head0":  # tpucomp's is int32: bit 31 is its sign
            w = w & 0xFFFFFFFF
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(got[4]) != 0  # the previous dispatch's open group has bits
    assert bool(got[8])


def next_from_right_loop(has, val):
    n = len(has)
    nh, nv = np.zeros(n, bool), np.zeros(n, np.int64)
    for i in range(n):
        for j in range(i + 1, n):
            if has[j]:
                nh[i], nv[i] = True, val[j]
                break
    return nh, nv


def suffix_or_loop(key, contrib):
    n = len(key)
    acc = np.zeros(n, np.int64)
    for i in range(n):
        j = i
        while j < n and key[j] == key[i]:
            acc[i] |= contrib[j]
            j += 1
    return acc


@pytest.mark.parametrize("seed", range(4))
def test_lane_scans_match_loops(seed):
    r = random.Random(seed)
    n = r.choice([1, 2, 9, 64])
    has = np.array([r.random() < 0.3 for _ in range(n)])
    val = np.array([r.randrange(16) for _ in range(n)], np.int32)
    nh, nv = xp.next_from_right(torch.from_numpy(has), torch.from_numpy(val))
    want_h, want_v = next_from_right_loop(has, val)
    np.testing.assert_array_equal(nh.numpy(), want_h)
    np.testing.assert_array_equal(nv.numpy(), want_v)
    # runs of equal keys (a lane's first group), distinct bits in a run
    key = np.cumsum([r.random() < 0.4 for _ in range(n)]).astype(np.int32)
    contrib = np.zeros(n, np.int64)
    for i in range(n):
        if r.random() < 0.7:
            contrib[i] = 1 << (31 - (i % 32))
    got = xp.segmented_suffix_or(torch.from_numpy(key),
                                 torch.from_numpy(contrib))
    np.testing.assert_array_equal(got.numpy(), suffix_or_loop(key, contrib))


def test_unit_size_refusals_and_empty_input():
    for u in (4096, 65537):
        with pytest.raises(ArgError):
            port_stream(b"abc", unit_size=u)
        with pytest.raises(t_xp.ArgError):
            t_xp.compress_stream(b"abc", unit_size=u)
        assert port_stream(b"", unit_size=u) == b""
        assert t_xp.compress_stream(b"", unit_size=u) == b""

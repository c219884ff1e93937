"""tpucomp_torch's dist layer and stats on the CPU against tpucomp's.

``tpucomp_torch.dist`` (``ShardedCodec``, ``Archive``/``Manifest``,
``ShardedLZNT1``, ``MixedBatch``) on one rank with ``data_mesh("cpu")``
(the kernels' plain versions) against ``tpucomp.dist`` on the 8-device
virtual CPU mesh of ``conftest.py``: archive bytes of all three formats
(LZNT1 at 4096, XPRESS and XPRESS_HUFF at 4096 and 8192) on 30000 bytes
and on 18101 bytes (5 units at 4096: tpucomp pads the batch to 8), each
package decoding the other's archive; resume; the resolved profile and
the port's copy of the native resolved encoders at depths 0, 1, 2 and 4;
the error classes; ``RunStats`` and ``device_trace``.  tpucomp's archives
are built once per module (its jit compiles dominate the time).  Every
value is a byte or an integer: the tolerance is exact equality.  Two
ranks are in ``test_torch_dist_multiprocess.py``.
"""

import json
import os
import random
import subprocess
import sys

import pytest
import torch

import tpucomp.dist as t_dist
from chip_smoke import literal_block
from conftest import make_corpus
from tpucomp import _native as t_native
from tpucomp import errors as t_errors
from tpucomp import stats as t_stats
from tpucomp.formats import Format as TFormat
from tpucomp_torch import _native, stats
from tpucomp_torch.dist import (Archive, DataMesh, Manifest, MixedBatch,
                                ShardedCodec, ShardedLZNT1, data_mesh,
                                local_device_count)
from tpucomp_torch.dist.sharded import _share
from tpucomp_torch.errors import ArgError, DataError
from tpucomp_torch.formats import Format
from _threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261018
SIZES = {"30000": 30000, "5units": 4 * 4096 + 1717}
# (format, unit_size) of every archive case
UNITS = [(Format.LZNT1, 4096), (Format.XPRESS, 4096), (Format.XPRESS, 8192),
         (Format.XPRESS_HUFF, 4096), (Format.XPRESS_HUFF, 8192)]
CASES = [(fmt, unit, size) for fmt, unit in UNITS for size in SIZES]
CPU = data_mesh("cpu")
# tpucomp's resolved encoders read depth state that the call before left
# (ROADMAP queue 3); a resolved encode of these bytes (all literals) sets
# it to zero.  The port's copy zeroes it at every call: it gives the bytes
# tpucomp gives right after this block.
LITERALS = literal_block()
RESOLVED = ("xh_compress_resolved", "xpress_compress_resolved")


def zeroed(fn):
    """``fn`` (one of tpucomp's resolved encoders) from a zeroed depth
    state at every call."""
    def call(data, *args):
        fn(LITERALS)
        return fn(data, *args)
    return call


def t_resolved(name, data, *args):
    return zeroed(getattr(t_native, name))(data, *args)


@pytest.fixture(scope="module")
def data():
    return {name: make_corpus(random.Random(SEED + k), n)
            for k, (name, n) in enumerate(SIZES.items())}


@pytest.fixture(scope="module")
def t_codecs():
    """tpucomp's ShardedCodec for each (format, unit_size), made once."""
    cache = {}

    def get(fmt, unit, **kw):
        key = (fmt, unit, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = t_dist.ShardedCodec(TFormat(int(fmt)),
                                             unit_size=unit, **kw)
        return cache[key]

    return get


@pytest.fixture(scope="module")
def ref_archives(data, t_codecs):
    """tpucomp's archive bytes of every case."""
    return {(fmt, unit, size): t_codecs(fmt, unit).compress(
        data[size]).to_bytes() for fmt, unit, size in CASES}


def port_codec(fmt, unit, **kw):
    return ShardedCodec(fmt, mesh=CPU, unit_size=unit, **kw)


# ---- archives -------------------------------------------------------------


@pytest.mark.parametrize("fmt,unit,size", CASES,
                         ids=[f"{f.name}-{u}-{s}" for f, u, s in CASES])
def test_archive_bytes_equal_tpucomp(data, t_codecs, ref_archives, fmt, unit,
                                     size):
    raw = data[size]
    ref = ref_archives[fmt, unit, size]
    sc = port_codec(fmt, unit)
    arch = sc.compress(raw)
    got = arch.to_bytes()
    assert got == ref
    assert len(arch.manifest.unit_out_lens) == -(-len(raw) // unit)
    assert sc.last_stats.in_bytes == len(raw)
    assert sc.last_stats.out_bytes == len(arch.payload)
    # each package decodes the other's archive
    assert sc.decompress(Archive.from_bytes(ref)) == raw
    assert t_codecs(fmt, unit).decompress(
        t_dist.Archive.from_bytes(got)) == raw
    # from_bytes round-trips in both directions
    assert Archive.from_bytes(ref).to_bytes() == ref
    assert t_dist.Archive.from_bytes(got).to_bytes() == got


def test_manifest_json_equals_tpucomp():
    kw = dict(fmt=int(Format.XPRESS_HUFF), unit_size=8192,
              unit_out_lens=[8192, 77], unit_comp_lens=[3001, 290],
              done_units=2, resolved=True)
    got = Archive(Manifest(**kw), b"xyz").to_bytes()
    assert got == t_dist.Archive(t_dist.Manifest(**kw), b"xyz").to_bytes()
    assert got.startswith(b"TPUC\x01")
    back = Archive.from_bytes(got)
    assert back.manifest == Manifest(**kw) and back.payload == b"xyz"
    assert back.total_out_len == 8192 + 77
    with pytest.raises(DataError):
        Archive.from_bytes(b"TPUC\x02" + got[5:])
    with pytest.raises(t_errors.DataError):
        t_dist.Archive.from_bytes(b"TPUC\x02" + got[5:])


@pytest.mark.parametrize("fmt,unit,k", [(Format.LZNT1, 4096, 3),
                                        (Format.XPRESS, 4096, 5),
                                        (Format.XPRESS_HUFF, 8192, 2)])
def test_resume(data, t_codecs, ref_archives, fmt, unit, k):
    """A partial archive of the first k units resumed: the one-call
    archive's bytes and tpucomp's resumed archive's.  Both packages
    append to the partial archive's manifest in place."""
    raw = data["30000"]
    sc = port_codec(fmt, unit)
    partial = sc.compress(raw[:k * unit])
    assert partial.manifest.done_units == k
    resumed = sc.compress(raw, resume=partial)
    assert resumed.to_bytes() == ref_archives[fmt, unit, "30000"]
    assert resumed.manifest is partial.manifest
    assert sc.last_stats.units == -(-len(raw) // unit) - k
    tc = t_codecs(fmt, unit)
    t_partial = tc.compress(raw[:k * unit])
    t_resumed = tc.compress(raw, resume=t_partial)
    assert t_resumed.manifest is t_partial.manifest
    assert t_resumed.to_bytes() == resumed.to_bytes()
    assert sc.decompress(resumed) == raw
    # nothing left to do: the archive comes back as it was
    again = sc.compress(raw, resume=resumed)
    assert again.to_bytes() == resumed.to_bytes()
    assert sc.last_stats.units == 0


# ---- the resolved profile ---------------------------------------------------


def _cases(corpus, rng):
    # tests/test_archive_fast.py's
    return [
        corpus(65536),
        corpus(30000),
        b"ab" * 32768,
        bytes(rng.randrange(256) for _ in range(8192)),
        corpus(4096) * 16,
    ]


def test_literal_block_is_all_literals():
    a = list(LITERALS)
    grams = {tuple(a[i:i + 3]) for i in range(len(a) - 2)}
    assert len(LITERALS) == 65536 and len(grams) == len(a) - 2
    # plain Xpress: a flag word a 32 literals, nothing else
    assert len(_native.xpress_compress_resolved(LITERALS)) == 65536 + 8192


@pytest.mark.parametrize("depth", [0, 1, 2, 4])
@pytest.mark.parametrize("name", RESOLVED)
def test_resolved_encoders_equal_native(corpus, rng, name, depth):
    for d in _cases(corpus, rng) + [b"", b"a"]:
        assert getattr(_native, name)(d, depth) == \
            t_resolved(name, d, depth), len(d)


def test_resolved_encoders_depend_on_the_call_before():
    """tpucomp's resolved XH encoder reads the depth state of a match's
    own positions before it writes it, so a block's bytes depend on the
    block encoded before it (ROADMAP queue 3).  The port's copy zeroes
    that state at every call: a block gives the bytes tpucomp gives from
    a zeroed state, whatever the port encoded before."""
    before, block = (make_corpus(random.Random(s), 65536) for s in (0, 3))
    alone = t_resolved("xh_compress_resolved", block)
    t_native.xh_compress_resolved(before)
    assert t_native.xh_compress_resolved(block) != alone
    for name in RESOLVED:
        fn = getattr(_native, name)
        want = t_resolved(name, block)
        assert fn(block) == want
        fn(before)
        assert fn(block) == want
        fn(LITERALS)
        assert fn(block) == want


@pytest.mark.parametrize("name", RESOLVED)
def test_resolved_encoders_default_and_depth_checks(corpus, name):
    d = corpus(20000)
    default = getattr(_native, name)(d)
    assert default == t_resolved(name, d)
    assert getattr(_native, name)(d, 2) == default
    for bad in (16, -1):
        with pytest.raises(ArgError):
            getattr(_native, name)(d, bad)
        with pytest.raises(t_errors.ArgError):
            getattr(t_native, name)(d, bad)


@pytest.mark.parametrize("fmt", [Format.XPRESS, Format.XPRESS_HUFF])
def test_resolved_archive(data, fmt, monkeypatch):
    """The port's resolved archive equals tpucomp's with every unit
    encoded from a zeroed depth state, and decodes through
    fast_resolve."""
    raw = data["30000"]
    sc = port_codec(fmt, 8192, resolve_offsets=True)
    for name in RESOLVED:
        monkeypatch.setattr(t_native, name, zeroed(getattr(t_native, name)))
    arch = sc.compress(raw)
    ref = t_dist.ShardedCodec(TFormat(int(fmt)), unit_size=8192,
                              resolve_offsets=True).compress(raw)
    assert arch.manifest.resolved and ref.manifest.resolved
    assert arch.to_bytes() == ref.to_bytes()
    seen = []
    real = sc._mod.decompress_units

    def spy(*args, **kw):
        seen.append(args[3] if len(args) > 3 else kw.get("fast_resolve"))
        return real(*args, **kw)

    monkeypatch.setattr(sc._mod, "decompress_units", spy)
    assert sc.decompress(Archive.from_bytes(arch.to_bytes())) == raw
    assert seen == [True]


# ---- ShardedLZNT1 and MixedBatch -----------------------------------------------


def test_sharded_lznt1(data):
    raw = data["5units"]
    port = ShardedLZNT1(CPU)
    ref = t_dist.ShardedLZNT1(t_dist.data_mesh())
    stream = port.compress(raw)
    assert stream == ref.compress(raw)
    assert port.decompress(stream) == raw
    assert ref.decompress(stream) == raw
    assert port.decompress(stream, 1000) == raw[:1000]
    assert port.compress(b"") == b"" and port.decompress(b"") == b""
    with pytest.raises(DataError):
        port.decompress(stream, len(raw) + 1)
    with pytest.raises(t_errors.DataError):
        ref.decompress(stream, len(raw) + 1)
    with pytest.raises(DataError):  # a chunk cut short
        port.decompress(stream[:-1])
    with pytest.raises(t_errors.DataError):
        ref.decompress(stream[:-1])
    bad = (0xB000 | 2).to_bytes(2, "little") + bytes([1, 0, 0])  # disp > pos
    with pytest.raises(DataError):
        port.decompress(bad)
    with pytest.raises(t_errors.DataError):
        ref.decompress(bad)


def test_mixed_batch(corpus, monkeypatch):
    jobs = [
        (Format.LZNT1, corpus(20000)),
        (Format.XPRESS_HUFF, corpus(12000)),
        (Format.XPRESS, corpus(9000)),
        (Format.LZNT1, corpus(5000)),
        (Format.XPRESS_HUFF, corpus(6000)),
    ]
    sizes = {Format.XPRESS: 4096, Format.XPRESS_HUFF: 4096}
    port = MixedBatch(mesh=CPU, unit_sizes=sizes)
    calls = []
    real = ShardedCodec._compress_units

    def counting(self, units):
        calls.append(self.fmt)
        return real(self, units)

    monkeypatch.setattr(ShardedCodec, "_compress_units", counting)
    archives = port.compress(jobs)
    assert sorted(calls) == [Format.LZNT1, Format.XPRESS, Format.XPRESS_HUFF]
    ref = t_dist.MixedBatch(unit_sizes={TFormat(int(f)): u
                                        for f, u in sizes.items()})
    t_archives = ref.compress([(TFormat(int(f)), d) for f, d in jobs])
    assert [a.to_bytes() for a in archives] == \
        [a.to_bytes() for a in t_archives]
    assert port.decompress(archives) == [d for _, d in jobs]


# ---- errors -------------------------------------------------------------------


def _lznt1_archive(units):
    m = Manifest(fmt=int(Format.LZNT1), unit_size=4096,
                 unit_out_lens=[4096] * len(units),
                 unit_comp_lens=[len(u) for u in units],
                 done_units=len(units))
    return Archive(m, b"".join(units))


def test_errors_match_tpucomp(data):
    raw = data["5units"]
    pairs = [
        (lambda: port_codec(Format.LZNT1, None, resolve_offsets=True),
         lambda: t_dist.ShardedCodec(TFormat.LZNT1, resolve_offsets=True)),
        (lambda: port_codec(Format.LZNT1, 8192),
         lambda: t_dist.ShardedCodec(TFormat.LZNT1, unit_size=8192)),
        (lambda: port_codec(Format.XPRESS_HUFF, 65537),
         lambda: t_dist.ShardedCodec(TFormat.XPRESS_HUFF, unit_size=65537)),
        (lambda: port_codec(Format.LZX, None),
         lambda: t_dist.ShardedCodec(TFormat.LZX)),
    ]
    for port, ref in pairs:
        with pytest.raises(ArgError):
            port()
        with pytest.raises(t_errors.ArgError):
            ref()
    # an XPRESS archive given to an XPRESS_HUFF codec
    arch = port_codec(Format.XPRESS, 4096).compress(raw)
    with pytest.raises(ArgError, match="format mismatch"):
        port_codec(Format.XPRESS_HUFF, 4096).decompress(arch)
    with pytest.raises(t_errors.ArgError, match="format mismatch"):
        t_dist.ShardedCodec(TFormat.XPRESS_HUFF, unit_size=4096).decompress(
            t_dist.Archive.from_bytes(arch.to_bytes()))
    # an archive of another unit_size in a MixedBatch
    arch = port_codec(Format.XPRESS, 8192).compress(raw)
    with pytest.raises(ArgError, match="unit_size mismatch"):
        MixedBatch(mesh=CPU, unit_sizes={Format.XPRESS: 4096}).decompress(
            [arch])
    with pytest.raises(t_errors.ArgError, match="unit_size mismatch"):
        t_dist.MixedBatch(unit_sizes={TFormat.XPRESS: 4096}).decompress(
            [t_dist.Archive.from_bytes(arch.to_bytes())])
    # a truncated LZNT1 unit, and one that copies from before its start
    good = ShardedLZNT1(CPU).compress(raw[:4096])
    for unit in (good[:-5], (0xB000 | 2).to_bytes(2, "little")
                 + bytes([1, 0, 0])):
        arch = _lznt1_archive([good, unit])
        with pytest.raises(ArgError):
            port_codec(Format.LZNT1, None).decompress(arch)
        with pytest.raises(t_errors.ArgError):
            t_dist.ShardedCodec(TFormat.LZNT1).decompress(
                t_dist.Archive.from_bytes(arch.to_bytes()))


def test_empty_lznt1_divergence():
    """tpucomp's LZNT1 ShardedCodec fails on an empty buffer (its one
    empty unit's header is 0x3000 | -1); the port's archive holds one unit
    of length 0 and decodes to b""."""
    with pytest.raises(OverflowError):
        t_dist.ShardedCodec(TFormat.LZNT1).compress(b"")
    sc = port_codec(Format.LZNT1, None)
    arch = sc.compress(b"")
    assert arch.manifest.unit_out_lens == [0]
    assert arch.manifest.unit_comp_lens == [0]
    assert arch.payload == b""
    assert sc.decompress(Archive.from_bytes(arch.to_bytes())) == b""


# ---- mesh, stats, imports ------------------------------------------------------


def test_data_mesh_without_a_group(monkeypatch):
    assert CPU == DataMesh(0, 1, torch.device("cpu"), None)
    assert local_device_count() == torch.cuda.device_count()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        data_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedCodec(Format.XPRESS)


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_shares_cover_the_units_in_order(world):
    for n in range(0, 20):
        spans = [_share(n, DataMesh(r, world, torch.device("cpu"), None))
                 for r in range(world)]
        assert [i for a, b in spans for i in range(a, b)] == list(range(n))
        assert all(b - a <= -(-n // world) for a, b in spans)


def test_run_stats_equal_tpucomp():
    kw = dict(fmt="XPRESS_HUFF", in_bytes=123457, out_bytes=45679, units=3,
              stored_raw_units=1, wall_s=0.0123456789)
    got, want = stats.RunStats(**kw), t_stats.RunStats(**kw)
    assert got.as_dict() == want.as_dict()
    assert list(got.as_dict()) == list(want.as_dict())
    assert stats.RunStats().as_dict() == t_stats.RunStats().as_dict()
    with stats.timed(got):
        pass
    assert got.wall_s > kw["wall_s"]


def test_device_trace_writes_a_trace(tmp_path, corpus):
    with stats.device_trace(None):
        pass
    assert not os.listdir(tmp_path)
    logdir = str(tmp_path / "trace")
    with stats.device_trace(logdir):
        torch.arange(1000).sum()
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        assert json.load(f)["traceEvents"]
    # ShardedCodec's trace_dir: one trace a compress and a decompress
    sc = ShardedCodec(Format.LZNT1, mesh=CPU, trace_dir=logdir)
    raw = corpus(3000)
    assert sc.decompress(sc.compress(raw)) == raw
    assert len(os.listdir(logdir)) == 3


def test_lost_launches_after_the_primer():
    """``device_trace``'s check: a kernel launch after the primer with no
    kernel record of its correlation id is lost; the primer's own lost
    records and launches with a record are not."""
    def launch(ts, corr):
        return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                "args": {"correlation": corr}}

    def kernel(ts, corr):
        return {"cat": "kernel", "name": "k", "ts": ts,
                "args": {"correlation": corr}}

    events = [{"cat": "user_annotation", "name": stats.PRIMER, "ts": 0,
               "dur": 50},
              launch(1, 1), launch(2, 2), kernel(3, 2),  # 1: the primer's
              launch(60, 3), kernel(61, 3),
              {"cat": "gpu_user_annotation", "name": stats.PRIMER,
               "ts": 0, "dur": 90},
              launch(70, 4),  # lost
              {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 80,
               "args": {"correlation": 5}}]
    assert stats.lost_launches(events) == [launch(70, 4)]
    assert stats.lost_launches(events[1:]) == [launch(1, 1), launch(70, 4)]
    assert stats.lost_launches([]) == []


def test_dist_imports_no_jax():
    code = ("import sys; before = set(sys.modules); import tpucomp_torch.dist, "
            "tpucomp_torch.stats, tpucomp_torch._native; "
            "print(sorted(m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'tpucomp')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    assert out.stdout.strip() == "[]"

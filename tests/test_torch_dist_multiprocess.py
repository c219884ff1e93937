"""tpucomp_torch's dist layer across two processes on the CPU.

Two processes form a gloo group over ``tcp://127.0.0.1:<free port>``,
one rank each on the CPU (``data_mesh("cpu")``), and run ``ShardedCodec``
in all three formats, ``ShardedLZNT1`` and ``MixedBatch`` on the same
seeded data: once with 7 units (shares of 4 and 3) and once with 1 unit
(rank 1 holds none).  Each process decodes what it made, and prints the
sha256 of every archive and stream, the resolved profile's included; they
must equal the one-rank results of the test process.  A unit that is
malformed in rank 1's share must raise ``ArgError`` on both ranks.
The one-rank archives are held to tpucomp's in ``test_torch_dist.py``.
This module imports no JAX: the worker processes import it.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch

from tpucomp_torch.dist import (Archive, Manifest, MixedBatch, ShardedCodec,
                                ShardedLZNT1, data_mesh)
from tpucomp_torch.errors import ArgError
from tpucomp_torch.formats import Format
from _threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
UNIT = 4096
SIZES = {"7units": 6 * UNIT + 1000, "1unit": 3000}
FORMATS = ("lznt1", "xpress", "xpress_huff")
WORDS = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps ", b"over ",
         b"lazy ", b"dog "]


def make_data(n: int, seed: int) -> bytes:
    """Mixed-entropy bytes from ``seed``: words, runs and random bytes."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        kind = rng.integers(3)
        if kind == 0:
            out += WORDS[rng.integers(len(WORDS))]
        elif kind == 1:
            out += bytes([rng.integers(256)]) * int(rng.integers(1, 40))
        else:
            out += rng.integers(0, 256, int(rng.integers(1, 20)),
                                dtype=np.uint8).tobytes()
    return bytes(out[:n])


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def results(mesh) -> dict:
    """The sha256 of every archive and stream on ``mesh``; each one also
    decodes back to its data here."""
    got = {}
    for k, (name, n) in enumerate(SIZES.items()):
        data = make_data(n, 20261018 + k)
        for fmt in FORMATS:
            sc = ShardedCodec(fmt, mesh=mesh, unit_size=UNIT)
            arch = sc.compress(data)
            assert sc.decompress(Archive.from_bytes(arch.to_bytes())) == data
            got[f"{fmt}-{name}"] = sha(arch.to_bytes())
        # the resolved profile (the port's encoders start every call from
        # a zeroed depth state, so a rank's share gives the same bytes)
        for fmt in FORMATS[1:]:
            sc = ShardedCodec(fmt, mesh=mesh, unit_size=UNIT,
                              resolve_offsets=True)
            arch = sc.compress(data)
            assert arch.manifest.resolved and sc.decompress(arch) == data
            got[f"{fmt}-resolved-{name}"] = sha(arch.to_bytes())
        sl = ShardedLZNT1(mesh)
        stream = sl.compress(data)
        assert sl.decompress(stream) == data
        got[f"ShardedLZNT1-{name}"] = sha(stream)
    jobs = [("xpress_huff", make_data(5000, 1)), ("lznt1", make_data(9000, 2)),
            ("xpress", make_data(2000, 3)), ("lznt1", make_data(100, 4))]
    mb = MixedBatch(mesh=mesh, unit_sizes={Format.XPRESS: UNIT,
                                           Format.XPRESS_HUFF: UNIT})
    archives = mb.compress(jobs)
    assert mb.decompress(archives) == [d for _, d in jobs]
    got["MixedBatch"] = sha(b"".join(a.to_bytes() for a in archives))
    return got


def malformed_in_rank1(mesh) -> None:
    """A 7-unit LZNT1 archive whose unit 5 (rank 1's share) copies from
    before its start: ``ArgError`` on every rank."""
    good = ShardedLZNT1(mesh).compress(make_data(UNIT, 5))
    bad = (0xB000 | 2).to_bytes(2, "little") + bytes([1, 0, 0])
    units = [good] * 5 + [bad, good]
    arch = Archive(Manifest(fmt=2, unit_size=UNIT,
                            unit_out_lens=[UNIT] * 7,
                            unit_comp_lens=[len(u) for u in units],
                            done_units=7), b"".join(units))
    with pytest.raises(ArgError):
        ShardedCodec("lznt1", mesh=mesh).decompress(arch)


def worker(port: int, rank: int) -> None:
    """One rank of the two-process group (run by the test in a child)."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=timedelta(seconds=120))
    try:
        mesh = data_mesh("cpu")
        assert (mesh.rank, mesh.world_size, mesh.backend) == (rank, 2, "gloo")
        got = results(mesh)
        malformed_in_rank1(mesh)
        print("RESULTS " + json.dumps(got), flush=True)
        print(f"WORKER_OK {rank}", flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_ranks_equal_one_rank():
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {TESTS!r}); "
         f"import test_torch_dist_multiprocess as m; m.worker({port}, {rank})"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO, env=env)
        for rank in range(2)]
    one = data_mesh("cpu")
    want = results(one)
    malformed_in_rank1(one)
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert f"WORKER_OK {rank}" in out, out[-3000:]
        line = next(l for l in out.splitlines() if l.startswith("RESULTS "))
        assert json.loads(line[len("RESULTS "):]) == want, rank


def test_one_rank_group_runs_the_collective(monkeypatch):
    """In a process group of one rank the rows go through the all-gather
    (a world of one without a group skips it); the archives are the
    same, and a failure is raised as it was."""
    import torch.distributed as dist

    data = make_data(SIZES["7units"], 20261018)
    want = {fmt: ShardedCodec(fmt, mesh=data_mesh("cpu"), unit_size=UNIT)
            .compress(data).to_bytes() for fmt in ("lznt1", "xpress")}
    gathers = []
    real = dist.all_gather
    monkeypatch.setattr(dist, "all_gather",
                        lambda *a, **k: gathers.append(1) or real(*a, **k))
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=60))
    try:
        mesh = data_mesh("cpu")
        assert (mesh.rank, mesh.world_size, mesh.backend) == (0, 1, "gloo")
        for fmt, raw in want.items():
            sc = ShardedCodec(fmt, mesh=mesh, unit_size=UNIT)
            arch = sc.compress(data)
            assert arch.to_bytes() == raw
            assert sc.decompress(arch) == data
        assert len(gathers) == 8  # two a compress and two a decompress
        malformed_in_rank1(mesh)
    finally:
        dist.destroy_process_group()

"""Data-parallel codecs for all formats, one process per GPU
(``tpucomp.dist.sharded``).

``ShardedCodec`` cuts a buffer into fixed-size units (independent by
format design), gives each rank of the :class:`~.mesh.DataMesh` a
contiguous share of ``ceil(N / W)`` of them, encodes or decodes the share
on the rank's device through the port's batch calls
(``codecs.*.compress_units`` / ``decompress_units``), and gathers every
share to every rank, which stitches them in unit order into an
:class:`~.archive.Archive` (or the decoded bytes), as
``process_allgather(tiled=True)`` gives every process the whole array in
tpucomp.

tpucomp's ``MeshJit`` has no counterpart: it binds GSPMD shardings to
jitted batch programs, and eager PyTorch has no program to shard.  The
rank's share of the units takes its place, and ``_host_gather`` the
collective: an all-gather of the lengths, then of the rows padded to the
longest.  It runs on the CPU under gloo and on the rank's GPU under NCCL.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import _native
from ..codecs import lznt1, xpress, xpress_huff
from ..errors import ArgError, DataError
from ..formats import Format, canonical
from ..stats import RunStats, device_trace, timed
from .archive import Archive, Manifest
from .mesh import DataMesh, data_mesh

# what a rank's failure is raised as on the other ranks (_host_gather)
_FAILURES = {1: ArgError, 2: DataError, 3: RuntimeError}


def _failure_code(failure: Optional[BaseException]) -> int:
    if failure is None:
        return 0
    if isinstance(failure, ArgError):
        return 1
    if isinstance(failure, DataError):
        return 2
    return 3


def _share(n: int, mesh: DataMesh) -> tuple[int, int]:
    """The [a, b) range of ``n`` items that ``mesh``'s rank holds: the
    rank-th of contiguous shares of ``ceil(n / W)`` (the last ones may be
    short or empty)."""
    s = -(-n // mesh.world_size)
    a = min(n, mesh.rank * s)
    return a, min(n, a + s)


def _host_gather(rows: List[bytes], n: int, mesh: DataMesh,
                 failure: Optional[BaseException] = None) -> List[bytes]:
    """Every rank's ``rows`` (its share of ``n``, see :func:`_share`), in
    rank order, on every rank.

    With no process group (a world of one): the identity.  Otherwise,
    in a group of any size, an all-gather of the rows' lengths (int64
    [ceil(n/W)], plus this rank's failure code), then of the rows padded
    to the longest over all ranks (uint8 [ceil(n/W), Lmax]); a rank with
    fewer rows sends zero-length ones.  The tensors lie on the CPU under
    gloo and on the rank's device under NCCL.  If any rank's share failed
    (``failure``), every rank raises: the failing rank its own exception,
    the others the same class naming that rank.
    """
    if mesh.backend is None:
        if failure is not None:
            raise failure
        return rows
    if n == 0:
        return []
    W, s = mesh.world_size, -(-n // mesh.world_size)
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    lens = torch.zeros(s + 1, dtype=torch.int64)
    lens[:len(rows)] = torch.tensor([len(r) for r in rows],
                                    dtype=torch.int64)
    lens[s] = _failure_code(failure)
    lens = lens.to(dev)
    all_lens = [torch.empty_like(lens) for _ in range(W)]
    dist.all_gather(all_lens, lens)
    all_lens = torch.stack(all_lens).cpu().numpy()
    codes = all_lens[:, s]
    if codes.any():
        if failure is not None:
            raise failure
        r = int(np.flatnonzero(codes)[0])
        raise _FAILURES[int(codes[r])](f"rank {r} of {W} failed on its "
                                       "share of the units")
    width = max(1, int(all_lens[:, :s].max()))
    buf = np.zeros((s, width), np.uint8)
    for k, row in enumerate(rows):
        buf[k, :len(row)] = np.frombuffer(row, np.uint8)
    buf = torch.from_numpy(buf).to(dev)
    bufs = [torch.empty_like(buf) for _ in range(W)]
    dist.all_gather(bufs, buf)
    out = []
    for r, b in enumerate(bufs):
        b = b.cpu().numpy()
        for k in range(max(0, min(n, (r + 1) * s) - r * s)):
            out.append(b[k, :all_lens[r, k]].tobytes())
    return out


def _run_sharded(mesh: DataMesh, n: int,
                 fn: Callable[[int, int], List[bytes]]) -> List[bytes]:
    """``fn(a, b)`` (the rows of items [a, b)) on this rank's share of
    ``n`` items, gathered in order from every rank."""
    a, b = _share(n, mesh)
    if mesh.backend is None:
        return fn(a, b)
    try:
        rows, failure = fn(a, b), None
    except Exception as e:  # raised on every rank by _host_gather
        rows, failure = [], e
    return _host_gather(rows, n, mesh, failure)


class ShardedCodec:
    """Data-parallel unit codec over the ranks of a :class:`DataMesh`
    (any format)."""

    def __init__(self, fmt, mesh=None, unit_size=None, trace_dir=None,
                 resolve_offsets=False):
        self.fmt = canonical(fmt)
        self.mesh = mesh if mesh is not None else data_mesh()
        self.last_stats = None
        # torch.profiler scope around every encode and decode
        # (stats.device_trace); None disables
        self.trace_dir = trace_dir
        # archive profile: encode XPRESS/XPRESS_HUFF units with the native
        # offset-resolved, depth-bounded encoder (tpucomp_torch._native)
        # and mark the manifest so that decompress takes fast_resolve.  The
        # streams stay standard [MS-XCA]; either profile decodes exactly.
        self.resolve_offsets = bool(resolve_offsets)
        if self.resolve_offsets and self.fmt == Format.LZNT1:
            raise ArgError(
                "resolve_offsets applies to XPRESS/XPRESS_HUFF (LZNT1 "
                "chunks resolve in-segment already)")
        if self.fmt == Format.LZNT1:
            self.unit_size = unit_size or lznt1.CHUNK
            if self.unit_size != lznt1.CHUNK:
                raise ArgError("LZNT1 units are fixed 4096-byte chunks")
            self._mod = lznt1
        elif self.fmt == Format.XPRESS:
            self.unit_size = unit_size or xpress.UNIT
            self._mod = xpress
        elif self.fmt == Format.XPRESS_HUFF:
            self.unit_size = unit_size or xpress_huff.BLOCK
            if self.unit_size > xpress_huff.BLOCK:
                raise ArgError("XPRESS_HUFF units are single <=64 KiB blocks")
            self._mod = xpress_huff
        else:
            raise ArgError(f"no sharded codec for {self.fmt.name}")

    # ---- encode ----------------------------------------------------------

    def compress(self, data: bytes, *,
                 resume: Optional[Archive] = None) -> Archive:
        """``data`` in units of ``unit_size`` -> an :class:`Archive`.

        With ``resume``, the units before ``resume.manifest.done_units``
        are taken as done: the new units' streams are appended to
        ``resume``'s manifest, which is updated in place as tpucomp's is,
        and the returned archive shares it.
        """
        data = bytes(data)
        u = self.unit_size
        units = [data[i:i + u] for i in range(0, len(data), u)] or [b""]
        start = resume.manifest.done_units if resume else 0
        manifest = (resume.manifest if resume
                    else Manifest(fmt=int(self.fmt), unit_size=u))
        payload = bytearray(resume.payload if resume else b"")
        todo = units[start:]
        stats = RunStats(fmt=self.fmt.name, units=len(todo))
        if todo:
            with timed(stats), device_trace(self.trace_dir,
                                               self.mesh.device):
                streams = self._compress_units(todo)
            for s, unit in zip(streams, todo):
                manifest.unit_out_lens.append(len(unit))
                manifest.unit_comp_lens.append(len(s))
                payload += s
            manifest.done_units = len(units)
            manifest.resolved = self.resolve_offsets
            stats.in_bytes = sum(len(t) for t in todo)
            stats.out_bytes = sum(len(s) for s in streams)
        self.last_stats = stats
        return Archive(manifest, bytes(payload))

    def _compress_units(self, units: List[bytes]) -> List[bytes]:
        """One stream per unit, each rank encoding its share."""
        dev = self.mesh.device
        if self.fmt == Format.LZNT1:
            def encode(share):
                return lznt1.compress_units(share, device=dev)
        elif self.resolve_offsets:
            enc = (_native.xh_compress_resolved
                   if self.fmt == Format.XPRESS_HUFF
                   else _native.xpress_compress_resolved)

            def encode(share):
                return [enc(u) for u in share]
        else:
            def encode(share):
                return self._mod.compress_units(share, self.unit_size,
                                                device=dev)
        return _run_sharded(self.mesh, len(units),
                            lambda a, b: encode(units[a:b]))

    # ---- decode ----------------------------------------------------------

    def decompress(self, archive: Archive) -> bytes:
        if archive.manifest.fmt != int(self.fmt):
            raise ArgError("archive format mismatch")
        streams = archive.unit_streams()
        stats = RunStats(fmt=self.fmt.name, units=len(streams),
                         out_bytes=len(archive.payload))
        with timed(stats), device_trace(self.trace_dir,
                                           self.mesh.device):
            parts = self._decompress_units(
                streams, archive.manifest.unit_out_lens,
                fast_resolve=bool(archive.manifest.resolved))
        out = b"".join(parts)
        stats.in_bytes = len(out)
        self.last_stats = stats
        return out

    def _decompress_units(self, streams: List[bytes], out_lens: List[int],
                          fast_resolve: bool = False) -> List[bytes]:
        """Each unit stream decoded, each rank decoding its share.  An
        LZNT1 unit may hold several chunks (a foreign stream); a
        truncated chunk or a malformed unit raises :class:`ArgError`."""
        dev = self.mesh.device
        if self.fmt == Format.LZNT1:
            def decode(a, b):
                return lznt1.decompress_units(streams[a:b], device=dev)
        else:
            def decode(a, b):
                return self._mod.decompress_units(
                    streams[a:b], out_lens[a:b], self.unit_size,
                    fast_resolve, device=dev)
        return _run_sharded(self.mesh, len(streams), decode)

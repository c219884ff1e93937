"""Mixed-format batch jobs (``tpucomp.dist.mixed``).

A batch of (format, payload) jobs, e.g. LZNT1, Xpress and Xpress Huffman
interleaved, is grouped by format; each group runs through its
``ShardedCodec`` over the same mesh in one call, and the results return
in job order.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..errors import ArgError
from ..formats import Format, canonical
from ..stats import RunStats, device_trace, timed
from .archive import Archive, Manifest
from .sharded import ShardedCodec


class MixedBatch:
    """Compress/decompress heterogeneous-format jobs over one mesh."""

    def __init__(self, mesh=None, unit_sizes=None):
        self.mesh = mesh
        self.unit_sizes = unit_sizes or {}
        self._codecs = {}

    def _codec(self, fmt: Format) -> ShardedCodec:
        if fmt not in self._codecs:
            self._codecs[fmt] = ShardedCodec(
                fmt, mesh=self.mesh, unit_size=self.unit_sizes.get(fmt))
        return self._codecs[fmt]

    def compress(self, jobs: Sequence[Tuple[object, bytes]]) -> List[Archive]:
        """jobs: [(format, data), ...] -> [Archive, ...] in job order.

        Same-format jobs are batched into ONE call per format: all jobs'
        units are concatenated, compressed together, and the streams split
        back per job.
        """
        by_fmt = {}
        for i, (fmt, data) in enumerate(jobs):
            by_fmt.setdefault(canonical(fmt), []).append((i, bytes(data)))
        results: List[Archive] = [None] * len(jobs)  # type: ignore
        for fmt, items in by_fmt.items():
            codec = self._codec(fmt)
            u = codec.unit_size
            all_units: List[bytes] = []
            spans = []  # (job index, first unit, unit count)
            for i, data in items:
                units = [data[k:k + u] for k in range(0, len(data), u)] or [b""]
                spans.append((i, len(all_units), len(units)))
                all_units += units
            # per-format stats and trace, as ShardedCodec.compress keeps
            stats = RunStats(fmt=fmt.name, units=len(all_units))
            with timed(stats), device_trace(codec.trace_dir,
                                               codec.mesh.device):
                streams = codec._compress_units(all_units)
            stats.in_bytes = sum(len(t) for t in all_units)
            stats.out_bytes = sum(len(s) for s in streams)
            codec.last_stats = stats
            for i, first, nu in spans:
                manifest = Manifest(fmt=int(fmt), unit_size=u)
                payload = bytearray()
                for k in range(first, first + nu):
                    manifest.unit_out_lens.append(len(all_units[k]))
                    manifest.unit_comp_lens.append(len(streams[k]))
                    payload += streams[k]
                manifest.done_units = nu
                results[i] = Archive(manifest, bytes(payload))
        return results

    def decompress(self, archives: Sequence[Archive]) -> List[bytes]:
        """Batched mirror of :meth:`compress`: all same-format archives'
        unit streams decode in one call per format."""
        by_fmt = {}
        for i, arch in enumerate(archives):
            by_fmt.setdefault(canonical(arch.manifest.fmt), []).append(i)
        out: List[bytes] = [None] * len(archives)  # type: ignore
        for fmt, idxs in by_fmt.items():
            codec = self._codec(fmt)
            all_streams: List[bytes] = []
            all_olens: List[int] = []
            spans = []
            for i in idxs:
                arch = archives[i]
                if arch.manifest.unit_size != codec.unit_size:
                    raise ArgError("archive unit_size mismatch in batch")
                streams = arch.unit_streams()
                spans.append((i, len(all_streams), len(streams)))
                all_streams += streams
                all_olens += arch.manifest.unit_out_lens
            stats = RunStats(fmt=fmt.name, units=len(all_streams),
                             out_bytes=sum(len(s) for s in all_streams))
            with timed(stats), device_trace(codec.trace_dir,
                                               codec.mesh.device):
                parts = codec._decompress_units(all_streams, all_olens)
            stats.in_bytes = sum(len(p) for p in parts)
            codec.last_stats = stats
            for i, first, nu in spans:
                out[i] = b"".join(parts[first:first + nu])
        return out

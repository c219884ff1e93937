"""Sharded archive container: unit manifest + per-unit streams, the port's
own copy of ``tpucomp.dist.archive``.

The [MS-XCA] formats carry no size headers, and only LZNT1 is
self-framing; batch and sharded operation therefore records unit
boundaries in a manifest.  An archive is::

    MAGIC  | manifest JSON (format, unit_size, per-unit compressed and
    uncompressed lengths) | concatenated per-unit streams

Every unit stream is a standard [MS-XCA] stream of its format.  For LZNT1
the concatenation (``payload``) is itself a standard LZNT1 stream.  The
same manifest gives the same bytes in both packages (the same JSON keys
in the same order), so archives move between them.

Checkpoint/resume: ``Manifest.done_units`` counts the units already
compressed; ``ShardedCodec.compress(data, resume=archive)`` goes on from
there.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List

from ..errors import DataError

MAGIC = b"TPUC\x01"


@dataclass
class Manifest:
    fmt: int
    unit_size: int
    unit_out_lens: List[int] = field(default_factory=list)
    unit_comp_lens: List[int] = field(default_factory=list)
    done_units: int = 0  # checkpoint: units already compressed/stitched
    # encoder profile: True = unit streams were written with the
    # offset-resolved, depth-bounded profile (tpucomp_torch._native), so
    # decompress may take fast_resolve, the far_probe rounds (the decoder
    # stays bit-correct either way; this only picks the cheap schedule)
    resolved: bool = False

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "fmt": int(self.fmt),
                "unit_size": self.unit_size,
                "unit_out_lens": self.unit_out_lens,
                "unit_comp_lens": self.unit_comp_lens,
                "done_units": self.done_units,
                "resolved": self.resolved,
            }
        ).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "Manifest":
        d = json.loads(raw.decode())
        return cls(
            fmt=d["fmt"],
            unit_size=d["unit_size"],
            unit_out_lens=list(d["unit_out_lens"]),
            unit_comp_lens=list(d["unit_comp_lens"]),
            done_units=d.get("done_units", 0),
            resolved=d.get("resolved", False),
        )


@dataclass
class Archive:
    manifest: Manifest
    payload: bytes  # concatenated unit streams, in unit order

    def to_bytes(self) -> bytes:
        mj = self.manifest.to_json()
        return MAGIC + len(mj).to_bytes(4, "little") + mj + self.payload

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Archive":
        if raw[: len(MAGIC)] != MAGIC:
            raise DataError("not a tpucomp archive (bad magic)")
        off = len(MAGIC)
        mlen = int.from_bytes(raw[off : off + 4], "little")
        off += 4
        manifest = Manifest.from_json(raw[off : off + mlen])
        return cls(manifest, raw[off + mlen :])

    def unit_streams(self) -> List[bytes]:
        out = []
        off = 0
        for cl in self.manifest.unit_comp_lens:
            out.append(self.payload[off : off + cl])
            off += cl
        return out

    @property
    def total_out_len(self) -> int:
        return sum(self.manifest.unit_out_lens)

"""LZNT1 over the ranks of a data mesh, one standard stream in and out
(``tpucomp.dist.batch``).

``ShardedLZNT1`` cuts a buffer into its 4 KiB chunks and gives each rank a
contiguous share of them, as ``ShardedCodec`` does with units; each rank
encodes or decodes its chunks in one batch on its device
(``codecs.lznt1``), and the framed chunks (or decoded bytes) are gathered
to every rank in chunk order.  LZNT1 chunks are self-framing (a 2-byte
header carries the payload's size), so the stitched result is a standard
LZNT1 stream, equal to ``codecs.lznt1.compress``'s.
"""

from __future__ import annotations

import numpy as np

from ..codecs import lznt1 as codec
from ..errors import DataError
from .mesh import DataMesh
from .sharded import _run_sharded


class ShardedLZNT1:
    """LZNT1 over a data-parallel :class:`DataMesh`."""

    def __init__(self, mesh: DataMesh):
        self.mesh = mesh

    # -- encode ------------------------------------------------------------

    def compress(self, data: bytes) -> bytes:
        data = bytes(data)
        if not data:
            return b""
        chunks, clen = codec.split_chunks(data)

        def encode(a, b):
            if a == b:
                return []
            return codec._encode_framed(chunks[a:b], clen[a:b],
                                        self.mesh.device)

        return b"".join(_run_sharded(self.mesh, len(clen), encode))

    # -- decode ------------------------------------------------------------

    def decompress(self, data: bytes, out_len=None) -> bytes:
        data = bytes(data)
        if not data:
            return b""
        payloads, comps = codec.split_stream(data)
        if not payloads:
            return b""

        def decode(a, b):
            if a == b:
                return []
            out, out_lens, err = codec.decode_batch(*codec.pack_chunks(
                payloads[a:b], comps[a:b], self.mesh.device))
            if bool(err.any()):
                raise DataError("LZNT1: malformed stream")
            flat = codec.joined_output(out, out_lens)
            lens = out_lens.cpu().tolist()
            return [flat[e - n:e]
                    for e, n in zip(np.cumsum(lens).tolist(), lens)]

        result = b"".join(_run_sharded(self.mesh, len(payloads), decode))
        if out_len is not None:
            if len(result) < out_len:
                raise DataError("LZNT1: stream ended before out_len bytes")
            result = result[:out_len]
        return result

"""The benchmark's plain reference decoders, one module a format."""

from __future__ import annotations

from . import lznt1, xpress_huff


def decode(fmt: str, streams: list, out_lens: list,
           block_copies: bool = False) -> list:
    """Each unit stream's decoded bytes, as the format defines them.

    LZNT1 streams end by themselves: they decode as one joined stream,
    cut back into units at ``out_lens`` (a unit of another length shows
    as wrong bytes).  Raises ValueError on a malformed stream."""
    if fmt == "lznt1":
        joined = lznt1.decode(b"".join(streams), block_copies)
        out, at = [], 0
        for n in out_lens:
            out.append(joined[at:at + n])
            at += n
        if at != len(joined):
            out[-1] += joined[at:]
        return out
    if fmt == "xpress_huff":
        return xpress_huff.decode_units(list(streams), list(out_lens),
                                        block_copies)
    raise ValueError(f"no reference decoder for format {fmt!r}")

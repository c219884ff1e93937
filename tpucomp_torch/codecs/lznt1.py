"""LZNT1 decode, chunk-parallel, on PyTorch tensors.

Counterpart of the decode half of ``tpucomp/codecs/lznt1.py``.  One row
of a batch is one 4 KiB chunk.  The pipeline:

  parse (kernel)  -> token records per payload byte step
  fill            -> per output byte: its token's literal or displacement
  near resolve (kernel) -> copies inside each 512-byte segment resolved,
                     the rest tagged with their absolute source
  far level (kernel)    -> pointer doubling over the whole row
                     (``common.far_rounds`` at U = 4096: one level)

Stored-raw chunks bypass the pipeline: their payload is the output.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import ArgError, DataError
from ..kernels.common import far_rounds, fill_records_delta
from ..kernels.lznt1_parse import COPY_BIT, lznt1_parse
from ..kernels.resolve import SEG, resolve_near
from ..util import resolve_device

CHUNK = 4096
# Compressed payload bound: 4096 literals + 512 flag bytes.
MAX_PAYLOAD = CHUNK + CHUNK // 8
# Input payload pad (also covers raw chunks).
PAYLOAD_PAD = MAX_PAYLOAD + 8


def batch_from_numpy(payload: np.ndarray, plen: np.ndarray,
                     is_comp: np.ndarray, device="cuda"):
    """Move the numpy batch that ``tpucomp.codecs.lznt1.decode_batch``
    takes (int32 [N, PAYLOAD_PAD], int32 [N], bool [N]) onto ``device``.

    The payload lands as uint8 (its values are bytes); plen as int32 and
    is_comp as bool.
    """
    dev = resolve_device(device)
    payload = np.asarray(payload)
    plen = np.asarray(plen, np.int32)
    is_comp = np.asarray(is_comp, bool)
    N = payload.shape[0]
    if payload.shape != (N, PAYLOAD_PAD) or plen.shape != (N,) \
            or is_comp.shape != (N,):
        raise ArgError(f"expected [N, {PAYLOAD_PAD}], [N] and [N] arrays")
    if N and (plen.min() < 0 or plen.max() > PAYLOAD_PAD):
        raise ArgError(f"plen must lie in [0, {PAYLOAD_PAD}]")
    return (torch.from_numpy(payload.astype(np.uint8)).to(dev),
            torch.from_numpy(plen).to(dev),
            torch.from_numpy(is_comp).to(dev))


def decode_batch(payload: torch.Tensor, plen: torch.Tensor,
                 is_comp: torch.Tensor):
    """Decode a batch of LZNT1 chunk payloads (headers already stripped).

    Args (all on one device, e.g. from :func:`batch_from_numpy`):
      payload: uint8 [N, PAYLOAD_PAD], per-chunk payload bytes, zero-padded.
      plen:    int32 [N], true payload byte length.
      is_comp: bool [N], compressed flag from each chunk header.

    Returns:
      out:     uint8 [N, CHUNK] decoded bytes (tpucomp returns int32; the
               values are equal), zero past out_len
      out_len: int32 [N] decoded length per chunk
      err:     bool [N] malformed-stream flag; the bytes of a row with
               err set are meaningless
    """
    rec_pos, rec_val, p_final, errk = lznt1_parse(payload, plen, is_comp)
    return _records_to_output(rec_pos, rec_val, p_final, errk != 0,
                              payload, plen, is_comp)


def _records_to_output(rec_pos, rec_val, p_final, err, payload, plen,
                       is_comp):
    """Decode tail: token records -> output bytes."""
    vpack = fill_records_delta(rec_pos, rec_val, CHUNK)
    is_copy = (vpack & COPY_BIT) != 0
    disp = vpack & (COPY_BIT - 1)
    litv = torch.where(is_copy, 0, vpack & 0xFF)
    out_comp = far_rounds(resolve_near(is_copy, disp, litv), CHUNK, SEG)
    out = torch.where(is_comp[:, None], out_comp.to(torch.uint8),
                      payload[:, :CHUNK])
    out_len = torch.where(is_comp, p_final, plen.clamp(max=CHUNK))
    j = torch.arange(CHUNK, device=out.device)
    out = torch.where(j < out_len[:, None], out, 0)
    return out, out_len, err


def split_stream(data: bytes):
    """Sequential header scan of an LZNT1 stream -> per-chunk payloads
    and compressed flags.  A 0x0000 header (or the end) ends the stream."""
    payloads, comps = [], []
    i, nb = 0, len(data)
    while i + 2 <= nb:
        header = data[i] | (data[i + 1] << 8)
        i += 2
        if header == 0:
            break
        size = (header & 0xFFF) + 1
        if i + size > nb:
            raise DataError("LZNT1: chunk payload extends past end of input")
        payloads.append(data[i: i + size])
        comps.append(bool(header & 0x8000))
        i += size
    return payloads, comps


def pack_chunks(payloads, comps, device):
    """Chunk payloads -> a batch on ``device``, one row per chunk.

    tpucomp pads the rows up to ``batch_multiple * 2^k`` to bound XLA
    recompiles; eager PyTorch has nothing to recompile, so no row here is
    padding."""
    N = len(payloads)
    payload = np.zeros((N, PAYLOAD_PAD), np.uint8)
    plen = np.zeros(N, np.int32)
    is_comp = np.zeros(N, bool)
    for k, (pl, cp) in enumerate(zip(payloads, comps)):
        payload[k, :len(pl)] = np.frombuffer(pl, np.uint8)
        plen[k] = len(pl)
        is_comp[k] = cp
    return (torch.from_numpy(payload).to(device),
            torch.from_numpy(plen).to(device),
            torch.from_numpy(is_comp).to(device))


def joined_output(out: torch.Tensor, out_len: torch.Tensor) -> bytes:
    """The first out_len[k] bytes of every row k, concatenated."""
    keep = torch.arange(CHUNK, device=out.device) < out_len[:, None]
    return out[keep].cpu().numpy().tobytes()


def decompress(data: bytes, out_len=None, *, device="cuda") -> bytes:
    """One-shot LZNT1 decode on ``device`` (chunk-parallel)."""
    dev = resolve_device(device)
    data = bytes(data)
    payloads, comps = split_stream(data)
    if not payloads:
        return b""
    out, out_lens, err = decode_batch(*pack_chunks(payloads, comps, dev))
    if bool(err.any()):
        raise DataError("LZNT1: malformed stream")
    result = joined_output(out, out_lens)
    if out_len is not None:
        if len(result) < out_len:
            raise DataError("LZNT1: stream ended before out_len bytes")
        result = result[:out_len]
    return result


def decompress_units(streams, *, device="cuda") -> list:
    """Decode independent LZNT1 unit streams in one batch.

    Each unit may hold several chunks: every unit is split into its chunks
    on the host, all chunks decode in one batch, and the output is
    reassembled per unit (as ``tpucomp.dist.ShardedCodec`` does).
    """
    dev = resolve_device(device)
    payloads, comps, owner = [], [], []
    for i, s in enumerate(streams):
        try:
            pls, cps = split_stream(bytes(s))
        except DataError as e:
            raise ArgError("LZNT1: truncated chunk in unit") from e
        payloads += pls
        comps += cps
        owner += [i] * len(pls)
    if not payloads:
        return [b"" for _ in streams]
    out, out_lens, err = decode_batch(*pack_chunks(payloads, comps, dev))
    if bool(err.any()):
        raise ArgError("LZNT1: malformed unit")
    flat = joined_output(out, out_lens)
    ends = np.cumsum(out_lens.cpu().numpy())
    parts = [[] for _ in streams]
    for k, i in enumerate(owner):
        parts[i].append(flat[ends[k - 1] if k else 0: ends[k]])
    return [b"".join(p) for p in parts]

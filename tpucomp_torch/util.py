"""Small host helpers shared by the port's codecs."""

from __future__ import annotations

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .stats import count, span


def resolve_device(device) -> torch.device:
    """``torch.device`` for a public entry point's ``device`` argument.

    Raises when CUDA is asked for and is not available: the port never
    carries on on the CPU by itself.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False")
    return dev


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array copied to ``device``: a ``copy.h2d`` span counting
    its bytes (``h2d_bytes``)."""
    t = torch.from_numpy(a)
    with span("copy.h2d", "copy"):
        count("h2d_bytes", t.nbytes)
        return t.to(device)


def to_host(t: torch.Tensor, site: str, pinned: bool = False) -> np.ndarray:
    """A device tensor copied back as a NumPy array: the sync span
    ``site`` counting its bytes (``d2h_bytes``).

    ``pinned`` copies a CUDA tensor into page-locked memory from torch's
    caching host allocator, which the next call reuses, in place of new
    pageable pages; the array holds that memory while it lives, so use it
    for an array that is read and dropped within the call.
    """
    with span(site, "sync"):
        count("d2h_bytes", t.nbytes)
        if pinned and t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return host.copy_(t).numpy()
        return t.cpu().numpy()


def staging_rows(n: int, width: int, device) -> np.ndarray:
    """An uninitialised uint8 [n, width] host array to fill and copy to
    ``device`` with :func:`to_device`.  For a CUDA device it is
    page-locked memory from torch's caching host allocator, which the next
    call reuses, in place of new pageable pages."""
    if torch.device(device).type == "cuda":
        return torch.empty((n, width), dtype=torch.uint8,
                           pin_memory=True).numpy()
    return np.empty((n, width), np.uint8)


# Rows are split by a few threads once a batch holds this many bytes: new
# bytes objects land in pages new to the process, and the host's cost of
# a new page, not the copy, bounds a single thread there.
SPLIT_PARALLEL_BYTES = 1 << 22
SPLIT_THREADS = 4

_new_bytes = ctypes.pythonapi.PyBytes_FromStringAndSize
_new_bytes.restype = ctypes.py_object
_new_bytes.argtypes = (ctypes.c_void_p, ctypes.c_ssize_t)
_bytes_data = ctypes.pythonapi.PyBytes_AsString
_bytes_data.restype = ctypes.c_void_p
_bytes_data.argtypes = (ctypes.py_object,)
_split_lock = threading.Lock()
_split_pool = None


def _pool() -> ThreadPoolExecutor:
    global _split_pool
    with _split_lock:
        if _split_pool is None:
            _split_pool = ThreadPoolExecutor(
                min(SPLIT_THREADS, os.cpu_count() or 1),
                thread_name_prefix="tpucomp-split")
        return _split_pool


def row_bytes(rows: np.ndarray, lens) -> list:
    """Row i's first ``lens[i]`` bytes of a uint8 [N, W] host array whose
    rows are contiguous, as bytes.

    A batch of :data:`SPLIT_PARALLEL_BYTES` or more is copied by
    :data:`SPLIT_THREADS` threads into bytes objects made uninitialised
    (``ctypes.memmove`` drops the interpreter lock while it copies);
    nothing else holds them until they are returned.
    """
    lens = [int(o) for o in lens]
    if len(lens) != rows.shape[0] or any(not 0 <= o <= rows.shape[1]
                                         for o in lens):
        raise ValueError("one length per row, each at most the row width")
    if rows.dtype != np.uint8 or (rows.size > 1 and rows.shape[1] > 1
                                  and rows.strides[1] != 1):
        raise ValueError("rows must be uint8 with contiguous rows")
    threads = min(SPLIT_THREADS, os.cpu_count() or 1)
    if sum(lens) < SPLIT_PARALLEL_BYTES or len(lens) < 2 or threads < 2:
        return [rows[i, :o].tobytes() for i, o in enumerate(lens)]
    outs = [_new_bytes(None, o) for o in lens]
    dst = [_bytes_data(b) for b in outs]
    base, stride, n = rows.ctypes.data, rows.strides[0], len(lens)

    def copy(k):
        for i in range(k * n // threads, (k + 1) * n // threads):
            if lens[i]:
                ctypes.memmove(dst[i], base + i * stride, lens[i])

    list(_pool().map(copy, range(threads)))
    return outs


def any_set(t: torch.Tensor, site: str) -> bool:
    """Whether any element of a device tensor is set: the sync span
    ``site``."""
    with span(site, "sync"):
        return bool(t.any())


@span("util.unit_rows", "stage")
def unit_rows(units: list, width: int, device):
    """Byte units of at most ``width`` bytes -> (uint8 [N, width] rows,
    zero-padded, and int32 [N] lengths) on ``device``."""
    rows = np.zeros((len(units), width), np.uint8)
    ulen = np.zeros(len(units), np.int32)
    for i, u in enumerate(units):
        rows[i, :len(u)] = np.frombuffer(u, np.uint8)
        ulen[i] = len(u)
    return to_device(rows, device), to_device(ulen, device)


@span("util.row_streams", "stage")
def row_streams(payload: torch.Tensor, plen: torch.Tensor) -> list:
    """Each row's first ``plen[i]`` bytes, as bytes, on the host."""
    payload = to_host(payload, "sync.row_payload")
    plen = to_host(plen, "sync.row_plen")
    return [payload[i, :plen[i]].tobytes() for i in range(len(plen))]

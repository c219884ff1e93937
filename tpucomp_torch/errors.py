"""Status taxonomy for tpucomp_torch: the same classes as ``tpucomp.errors``.

The port keeps its own copy so that importing it never imports JAX
(``import tpucomp`` does, unless ``TPUCOMP_NO_JAX=1``).

Mirrors the reference library's status codes (``MSCompStatus`` in
``include/mscomp/general.h`` of coderforlife/ms-compress — mount unavailable,
see SURVEY.md §0; recalled surface) as a Python exception hierarchy plus an
``Status`` enum for APIs that prefer status returns over raising.

Reference parity (SURVEY.md §2 row 1):
    MSCOMP_OK / MSCOMP_STREAM_END / MSCOMP_POSSIBLE_STREAM_END /
    MSCOMP_DATA_ERROR / MSCOMP_ARG_ERROR / MSCOMP_BUF_ERROR / MSCOMP_MEM_ERROR
"""

from __future__ import annotations

import enum


class Status(enum.IntEnum):
    """Status codes, numerically mirroring the reference's MSCompStatus."""

    OK = 0
    STREAM_END = 1
    POSSIBLE_STREAM_END = 2
    DATA_ERROR = -1
    ARG_ERROR = -2
    BUF_ERROR = -3
    MEM_ERROR = -4


class MSCompError(Exception):
    """Base class for all tpucomp errors."""

    status: Status = Status.DATA_ERROR

    def __init__(self, message: str = ""):
        super().__init__(message or self.__class__.__doc__)


class DataError(MSCompError):
    """The compressed data is corrupt or malformed (MSCOMP_DATA_ERROR)."""

    status = Status.DATA_ERROR


class ArgError(MSCompError):
    """An argument was invalid (MSCOMP_ARG_ERROR)."""

    status = Status.ARG_ERROR


class BufError(MSCompError):
    """The output buffer is too small (MSCOMP_BUF_ERROR)."""

    status = Status.BUF_ERROR


class MemError(MSCompError):
    """Memory allocation failed (MSCOMP_MEM_ERROR)."""

    status = Status.MEM_ERROR


class UnsupportedFormatError(ArgError):
    """The requested compression format is not supported."""


STATUS_TO_ERROR = {
    Status.DATA_ERROR: DataError,
    Status.ARG_ERROR: ArgError,
    Status.BUF_ERROR: BufError,
    Status.MEM_ERROR: MemError,
}


def raise_for_status(status: Status, message: str = "") -> None:
    """Raise the exception matching a non-OK status (OK/stream-end pass)."""
    if status in STATUS_TO_ERROR:
        raise STATUS_TO_ERROR[status](message)

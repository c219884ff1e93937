"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, at first use, under
``tpucomp_torch/_build/``.  The library's name carries a hash of the
flags and the sources, so a change to either builds a new one.  It is
loaded with ``ctypes``: pointers and the CUDA stream pass as
``c_void_p``, sizes as ``c_int``, and every entry point returns the
launch's ``cudaGetLastError()``.

Nothing here runs at import time.  With no ``nvcc`` or a failed build,
:func:`build` raises; no caller falls back to another path.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under $CUDA_HOME/bin or /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.access(cand, os.X_OK):
                return cand
    raise RuntimeError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin; "
        "the CUDA kernels cannot be built")


def shared_library(compiler: str, flags: list[str], srcs: list[str],
                   name: str) -> tuple[str, str]:
    """Compile ``srcs`` into ``BUILD_DIR/lib<name>-<key>.so`` unless that
    library exists.  ``key`` hashes ``flags`` and the sources' bytes.

    Returns the library's path and the compiler's output ("" when the
    library was already built); raises if the compiler fails.
    """
    h = hashlib.sha256("\0".join(flags).encode())
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a private name, then rename: a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, *srcs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{compiler} failed (rc {proc.returncode}):\n{proc.stdout}"
                f"{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, proc.stdout + proc.stderr


def build() -> tuple[str, str]:
    """Compile the kernels unless they are built already.

    Returns the library's path and nvcc's output (its ``-Xptxas -v``
    register and shared-memory report), "" when nothing was compiled.
    """
    return shared_library(find_nvcc(), NVCC_FLAGS, sources(),
                          "tpucomp_torch_kernels")


def use_kernel(*tensors: torch.Tensor) -> bool:
    """A wrapper's dispatch: False for CPU tensors (the plain version
    runs), True for CUDA tensors (the kernel runs); anything else raises.
    """
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device type {kind!r}")
    return kind == "cuda"


def launch(name: str, tensors: list[torch.Tensor], ints: list[int]) -> None:
    """Launch the library's entry point ``name`` on PyTorch's current
    stream of the tensors' device; raise if the launch failed.

    Every entry point takes the tensors' device pointers, then ``ints``
    as C ints, then the stream, and returns ``cudaGetLastError()``.  The
    library is built and loaded on first use.
    """
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build()[0])
    fn = getattr(_lib, name)
    fn.argtypes = ([ctypes.c_void_p] * len(tensors)
                   + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*[t.data_ptr() for t in tensors], *ints, stream)
    if rc != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError_t {rc}")

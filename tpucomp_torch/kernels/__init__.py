"""Kernels of the port.  Each of ``lznt1_parse``, ``resolve`` and
``gather`` holds a wrapper that launches a CUDA kernel (``csrc/*.cu``) on
CUDA tensors and runs the plain PyTorch version beside it on CPU tensors;
each wrapper counts its launches in ``<wrapper>.launches``."""

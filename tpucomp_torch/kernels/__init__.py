"""Kernels of the port.  Each of ``lznt1_parse``, ``xh_parse``, ``fill``,
``resolve``, ``gather``, ``runs``, ``sort``, ``commit`` and ``huffman``
(``huffman_tables``) holds wrappers that launch a CUDA kernel
(``csrc/*.cu``) on CUDA tensors and run the plain PyTorch version beside
it on CPU tensors; each wrapper counts its launches in
``<wrapper>.launches`` through ``stats.launched``, which also counts
``launches.<wrapper>`` on the open request while a profiler session
records.  The rest of ``huffman``, ``match`` (around the ``sort``
kernel) and ``common`` are plain PyTorch."""

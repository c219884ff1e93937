"""CPU oracle codecs — spec-exact [MS-XCA] transcriptions.

The port's own copy of ``tpucomp/oracle``: the same pure-Python code,
raising the port's exception classes, so that ``backend="oracle"`` of
:mod:`tpucomp_torch.api` never imports tpucomp.  tpucomp holds its copy
as the correctness ground truth for its device codecs (SURVEY.md §0
protocol item 2: no reference binary, so a small, obviously-correct CPU
codec stands in as the bit-compatibility oracle).

Modules:
    lznt1        — [MS-XCA] §2.5 LZNT1
    xpress       — [MS-XCA] §2.3–2.4 plain LZ77
    xpress_huff  — [MS-XCA] §2.1–2.2 LZ77+Huffman
    huffman      — shared length-limited canonical Huffman (package-merge)
"""

from . import lznt1, xpress, xpress_huff  # noqa: F401

"""Populate the codec registry with the port's backends, as
``tpucomp._register`` does with tpucomp's.

Imported from ``tpucomp_torch/__init__.py``.  It registers, for each of
LZNT1, XPRESS and XPRESS_HUFF:

* ``"oracle"`` — the port's copy of the spec codecs, with their
  ``max_compressed_size``;
* ``"cpu"``    — the port's copy of the native C codec
  (:func:`tpucomp_torch._native.register_all`).  Its build stays at
  first use and a failed build raises there: nothing here catches it,
  where tpucomp's registry skips the backend;
* ``"device"`` — the port's codecs (:mod:`tpucomp_torch.codecs`), whose
  calls take ``device=`` (tpucomp's ``"tpu"``).
"""

from __future__ import annotations

from . import _native
from .codecs import lznt1 as _d_lznt1
from .codecs import xpress as _d_xpress
from .codecs import xpress_huff as _d_xh
from .formats import Format, register
from .oracle import lznt1 as _o_lznt1
from .oracle import xpress as _o_xpress
from .oracle import xpress_huff as _o_xh

for _fmt, _oracle, _device in ((Format.LZNT1, _o_lznt1, _d_lznt1),
                               (Format.XPRESS, _o_xpress, _d_xpress),
                               (Format.XPRESS_HUFF, _o_xh, _d_xh)):
    register(_fmt, "oracle", _oracle.compress, _oracle.decompress,
             max_compressed_size=_oracle.max_compressed_size)
    register(_fmt, "device", _device.compress, _device.decompress)

_native.register_all()

"""The benchmark's plain reference decoders, one module a format.

A format's reference is the module ``ref/<format>.py`` under the
benchmark's root, found by the format's name: it defines
``decode_units(streams, out_lens, block_copies=False)``, which returns
each unit stream's decoded bytes and raises ValueError on a malformed
stream.  ``ref.<format>`` is that module of the root here.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import os
import re
import sys

from ..spec import ROOT

_NAME = re.compile(r"[a-z0-9_]+")


def module(fmt: str, root: str = ROOT):
    """The reference module of format ``fmt`` under ``root``; raises
    ValueError where there is none."""
    path = os.path.join(root, "ref", f"{fmt}.py")
    if not _NAME.fullmatch(fmt) or not os.path.isfile(path):
        raise ValueError(f"no reference decoder for format {fmt!r} "
                         f"(looked for {path})")
    if os.path.abspath(root) == ROOT:
        return importlib.import_module(f"{__name__}.{fmt}")
    key = hashlib.sha256(os.path.abspath(path).encode()).hexdigest()[:16]
    name = f"portbench_ref_{key}_{fmt}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


def decode(fmt: str, streams: list, out_lens: list,
           block_copies: bool = False, root: str = ROOT) -> list:
    """Each unit stream's decoded bytes, as format ``fmt`` defines them
    (``block_copies``: the control, see each format's module).  Raises
    ValueError on a malformed stream or a format with no reference."""
    return module(fmt, root).decode_units(list(streams), list(out_lens),
                                          block_copies)


def __getattr__(name: str):
    try:
        return module(name)
    except ValueError:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}") from None

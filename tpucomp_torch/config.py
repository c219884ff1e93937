"""Match-finder parameters of the port's encoders.

The port's copy of ``tpucomp.config.MatchFinderConfig``: the same fields
and defaults.  A codec has no weights; these are its parameters, carried
across packages as a plain dict (:meth:`MatchFinderConfig.to_dict`,
:func:`match_config_from_dict`).  tpucomp reads its config once per
trace; the port's encoders take one as an argument (``match=``) and use
:data:`DEFAULT` when it is None.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, fields
from typing import Tuple


@dataclass(frozen=True)
class MatchFinderConfig:
    hash_bits: int = 13
    num_candidates: int = 3  # same-hash candidates tried per position
    cap: int = 32  # capped compare depth (bytes) for hash candidates
    run_disps: Tuple[int, ...] = (1, 2, 3)  # exact small-displacement runs
    # second finder pass with a 5-byte hash seed (0 = off); used by the
    # Xpress encoders, not by LZNT1
    second_hash_cands: int = 0

    def to_dict(self) -> dict:
        d = asdict(self)
        d["run_disps"] = list(self.run_disps)
        return d


def match_config_from_dict(d: dict) -> MatchFinderConfig:
    """A config from a dict of its fields; a missing field keeps its
    default, an unknown one raises ``ValueError``."""
    names = {f.name for f in fields(MatchFinderConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown match-finder fields: {sorted(unknown)}")
    d = dict(d)
    if "run_disps" in d:
        d["run_disps"] = tuple(int(x) for x in d["run_disps"])
    return MatchFinderConfig(**d)


DEFAULT = MatchFinderConfig()

"""The segment model of ``test_torch_xh_segment`` against the plain parse
on 64 KiB of seeded random bytes: the longest XH body, at substep tier 3,
whose rows the kernel decodes under entry hypotheses.  Alone in its file:
the plain parse loops once per body byte, about a minute here.  Every
value is an integer: the tolerance is exact equality.
"""

import numpy as np

from test_torch_xh_segment import _hold, rows_batch
from tpucomp_torch.codecs import xpress_huff as xh
from _threads import _one_thread  # noqa: F401


def test_random_unit_64k():
    """64 KiB of seeded random bytes (tier 3: every code 8 bits or
    more) by the port's XH encoder: its rows decode under the tier-3
    hypotheses with no segment re-decoded."""
    r = np.random.default_rng(64)
    unit = r.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
    stream = xh.compress_units([unit], device="cpu")[0]
    args = rows_batch([(stream, 1 << 16)], 1 << 16)
    assert int(args[3][0]) == 3 and int(args[1][0]) > 65536
    rounds, = _hold(args, 1 << 16)
    assert rounds.tolist() == [0]

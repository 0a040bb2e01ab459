"""Seeds of a run: every random stream of a cell comes from ``--seed``."""
from __future__ import annotations

import numpy as np


def derive(seed: int, stream: int, index: int = 0) -> int:
    """A 63-bit seed for stream ``stream`` (and item ``index``) of a run:
    any whole ``seed``, negative or above 64 bits, maps to one."""
    ss = np.random.SeedSequence([seed & (2**64 - 1), seed >> 64 & (2**64 - 1),
                                 stream, index])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))

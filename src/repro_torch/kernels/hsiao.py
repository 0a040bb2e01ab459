"""Hsiao SEC-DED (72,64) code tables, shared by the CUDA kernels (loaded
into their constant memory at library load) and the plain PyTorch
versions. A copy of ``repro.kernels.hsiao``: the tables must stay equal.

The parity-check matrix H has 72 columns of 8 bits each:
  * 64 data columns: distinct odd-weight vectors (weight 3 first, then
    weight 5) — odd weight guarantees single-vs-double error separation
    (any double-error syndrome has even weight and can never alias a
    correctable single-error syndrome);
  * 8 check columns: unit vectors e_j (parity bit j only checks itself).

Encoding: ecc_j = XOR of data bits i with H[j, i] = 1, i.e. the parity of
(word & mask_j). The masks are also kept as 32-bit halves (MASK_LO/MASK_HI)
as in the reference; the port's kernels use the whole 64-bit mask.
"""
from __future__ import annotations

from itertools import combinations

import numpy as np

N_DATA = 64
N_CHECK = 8


def _columns() -> np.ndarray:
    cols = []
    for w in (3, 5):
        for bits in combinations(range(N_CHECK), w):
            cols.append(sum(1 << b for b in bits))
            if len(cols) == N_DATA:
                return np.array(cols, dtype=np.uint32)
    raise AssertionError


DATA_COLS: np.ndarray = _columns()                 # (64,) 8-bit codes
CHECK_COLS: np.ndarray = np.array([1 << j for j in range(N_CHECK)],
                                  dtype=np.uint32)

# parity masks: mask_j has bit i set iff data bit i participates in parity j
_mask64 = np.zeros(N_CHECK, dtype=np.uint64)
for i, c in enumerate(DATA_COLS):
    for j in range(N_CHECK):
        if (int(c) >> j) & 1:
            _mask64[j] |= np.uint64(1 << i)
MASK_LO: np.ndarray = (_mask64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
MASK_HI: np.ndarray = (_mask64 >> np.uint64(32)).astype(np.uint32)

# syndrome -> action lookup (256 entries):
#   -1: clean/no action needed beyond nothing (syndrome 0)
#   0..63: flip data bit k
#   64..71: ECC bit (syndrome-k-64) itself flipped -> rewrite ECC
#   -2: uncorrectable (double error)
SYNDROME_ACTION: np.ndarray = np.full(256, -2, dtype=np.int32)
SYNDROME_ACTION[0] = -1
for i, c in enumerate(DATA_COLS):
    SYNDROME_ACTION[int(c)] = i
for j, c in enumerate(CHECK_COLS):
    SYNDROME_ACTION[int(c)] = 64 + j

assert len(set(DATA_COLS.tolist())) == N_DATA
assert not (set(DATA_COLS.tolist()) & set(CHECK_COLS.tolist()))

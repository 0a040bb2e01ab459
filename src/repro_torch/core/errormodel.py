"""Memory error model: soft (transient) and hard (sticky) single/multi-bit
errors, with a less-tested device class at an elevated raw rate.

Rates follow the shape of the field studies the paper cites (Schroeder+09,
Meza+15, Sridharan+12): errors arrive per GB-month; a fraction are hard
(recurring at the same physical location until retired/repaired); hard
errors are more likely to be multi-bit. ``less_tested`` scales the raw
incidence by ``LESS_TESTED_FACTOR`` (the device class the paper's /L design
points buy at a testing-cost discount). Constant values and provenance:
docs/DESIGN.md §8.3.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Tuple

import numpy as np

LESS_TESTED_FACTOR = 4.0
HOURS_PER_MONTH = 30 * 24

# Fraction of injection events striking >1 bit of one 64-bit word. One
# value, shared by the ErrorModel dataclass, ``InjectionPlan.sample`` and
# ``MemoryDomain.inject``.
DEFAULT_MULTI_BIT_FRACTION = 0.02
# Of those multi-bit events, the fraction that are *adjacent* (bit i, i+1)
# bursts rather than two independent bits — field studies (Meza+15,
# arXiv:1901.03401) find spatially-correlated multi-bit faults dominate.
DEFAULT_ADJACENT_FRACTION = 0.5


@dataclass(frozen=True)
class ErrorModel:
    # raw incident error events per GB of app data per month (unprotected)
    errors_per_gb_month: float = 67.5
    hard_fraction: float = 0.4          # sticky errors (device defects)
    multi_bit_fraction: float = DEFAULT_MULTI_BIT_FRACTION
    adjacent_fraction: float = DEFAULT_ADJACENT_FRACTION
    less_tested: bool = False

    @property
    def rate_per_gb_month(self) -> float:
        f = LESS_TESTED_FACTOR if self.less_tested else 1.0
        return self.errors_per_gb_month * f

    def errors_per_month(self, gb: float) -> float:
        return self.rate_per_gb_month * gb

    def with_less_tested(self, flag: bool = True) -> "ErrorModel":
        return replace(self, less_tested=flag)


@dataclass
class InjectionPlan:
    """A concrete set of bit flips for one emulation trial (Fig. 2 step 2).

    word_idx/bit_idx address the packed 64-bit-word space of one tensor.
    ``hard`` errors re-assert after every write (the injector re-applies
    them each step); soft errors flip once.
    """
    word_idx: np.ndarray          # (E,) int32, -1 padding
    bit_idx: np.ndarray           # (E,) int32
    hard: bool

    @classmethod
    def sample(cls, rng: np.ndarray, n_words: int, n_errors: int,
               hard: bool,
               multi_bit_fraction: float = DEFAULT_MULTI_BIT_FRACTION,
               adjacent_fraction: float = DEFAULT_ADJACENT_FRACTION,
               pad_to: int = 8) -> "InjectionPlan":
        rng = np.random.default_rng(rng)
        words = rng.integers(0, n_words, size=n_errors)
        bits = rng.integers(0, 64, size=n_errors)
        # multi-bit events: add a second flip in the same word — adjacent
        # (correlated burst) with p = adjacent_fraction, else a distinct
        # random bit (never the same bit: two flips would cancel).
        # Fully vectorized: one uniform per event decides multi-bit, then
        # one uniform + one alternate-bit draw per selected event
        # (tests/test_hrm.py pins the stream for a fixed seed).
        multi = rng.random(n_errors) < multi_bit_fraction
        extra_w = words[multi]
        n_multi = len(extra_w)
        if n_multi:
            adj = rng.random(n_multi) < adjacent_fraction
            alt = rng.integers(0, 63, size=n_multi)
            b = bits[multi]
            b_adj = np.where(b < 63, b + 1, b - 1)
            b_alt = np.where(alt >= b, alt + 1, alt)
            extra_b = np.where(adj, b_adj, b_alt)
        else:
            extra_b = np.empty(0, dtype=np.int64)
        words = np.concatenate([words, extra_w.astype(np.int64)])
        bits = np.concatenate([bits, extra_b.astype(np.int64)])
        e = max(pad_to, -(-len(words) // pad_to) * pad_to)
        wi = np.full(e, -1, np.int32)
        bi = np.zeros(e, np.int32)
        wi[:len(words)] = words
        bi[:len(bits)] = bits
        return cls(wi, bi, hard)

    @classmethod
    def adjacent_burst(cls, rng: np.ndarray, n_words: int, n_bursts: int,
                       hard: bool = False, pad_to: int = 8
                       ) -> "InjectionPlan":
        """A storm of pure adjacent double-bit bursts: every event flips
        bits (b, b+1) of one word — the spatially-correlated failure mode
        that is silent under parity, detected-uncorrectable under SEC-DED,
        and correctable under the BURST / DEC-TED tiers."""
        rng = np.random.default_rng(rng)
        words = rng.integers(0, n_words, size=n_bursts)
        bits = rng.integers(0, 63, size=n_bursts)
        wi_list = np.repeat(words, 2)
        bi_list = np.stack([bits, bits + 1], axis=1).reshape(-1)
        e = max(pad_to, -(-len(wi_list) // pad_to) * pad_to)
        wi = np.full(e, -1, np.int32)
        bi = np.zeros(e, np.int32)
        wi[:len(wi_list)] = wi_list
        bi[:len(bi_list)] = bi_list
        return cls(wi, bi, hard)

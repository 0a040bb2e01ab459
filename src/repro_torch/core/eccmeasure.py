"""Measured per-tier error outcomes, driven through the tier kernels.

Counterpart of ``repro.core.eccmeasure``. For each tier and each strike
class (single bit, random double, adjacent-double burst) this module
strikes random payload words, runs the tier's encode and scrub (on the
card, the CUDA kernels; on the CPU, their plain versions), and classifies
every event as

  corrected   scrub restored the exact clean bits
  detected    scrub flagged the word detected-uncorrectable
  silent      the data stays (or ends up) wrong with no flag: SDC

One event per packed row, so outcomes attribute exactly. The words and
strikes are the reference's numpy stream (``default_rng((seed,
class_index))``, then ``_strike``, then ``_flip`` on uint32 lanes), so the
rates are the reference's, equal as floats. ``measured_outcome_rates``
mixes the per-class rates with the incident-error composition.
``availability.paper_design_availability`` turns them into the Fig. 5 rows
of the strong-ECC design points.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.tiers import Tier
from repro_torch.kernels.burst import burst_encode_words, burst_scrub_words
from repro_torch.kernels.dected import dected_encode_words, dected_scrub_words
from repro_torch.kernels.ops import LANES
from repro_torch.kernels.parity import parity_check_words, parity_encode_words
from repro_torch.kernels.ref import unpack_bits
from repro_torch.kernels.secded import secded_encode_words, secded_scrub_words

STRIKE_CLASSES = ("single", "double_random", "double_adjacent")


@dataclass(frozen=True)
class TierOutcomeRates:
    """P(outcome | incident error event) for one tier."""
    corrected: float
    detected: float
    silent: float

    def mix(self, other: "TierOutcomeRates", w_other: float
            ) -> "TierOutcomeRates":
        w = 1.0 - w_other
        return TierOutcomeRates(
            self.corrected * w + other.corrected * w_other,
            self.detected * w + other.detected * w_other,
            self.silent * w + other.silent * w_other)


def _strike(rng: np.random.Generator, rows: int, strike: str
            ) -> Tuple[np.ndarray, np.ndarray]:
    """One event per row: (word-in-row, list-of-bits) per event."""
    words = rng.integers(0, LANES, size=rows)
    if strike == "single":
        bits = rng.integers(0, 64, size=rows)[:, None]
    elif strike == "double_adjacent":
        b = rng.integers(0, 63, size=rows)
        bits = np.stack([b, b + 1], axis=1)
    elif strike == "double_random":
        b1 = rng.integers(0, 64, size=rows)
        b2 = rng.integers(0, 63, size=rows)
        b2 = np.where(b2 >= b1, b2 + 1, b2)
        bits = np.stack([b1, b2], axis=1)
    else:
        raise ValueError(strike)
    return words, bits


def _flip(lo: np.ndarray, hi: np.ndarray, words: np.ndarray,
          bits: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    lo, hi = lo.copy(), hi.copy()
    rows = np.arange(lo.shape[0])
    for k in range(bits.shape[1]):
        b = bits[:, k]
        is_lo = b < 32
        lo[rows, words] ^= np.where(is_lo, np.uint32(1) << b,
                                    0).astype(np.uint32)
        hi[rows, words] ^= np.where(is_lo, 0, np.uint32(1)
                                    << (b - 32)).astype(np.uint32)
    return lo, hi


def _words(lo: np.ndarray, hi: np.ndarray, device) -> torch.Tensor:
    """uint32 lanes -> packed int64 words ``lo | hi << 32`` on ``device``."""
    w = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    return torch.from_numpy(w.view(np.int64)).to(device)


_CODECS = {
    Tier.SECDED: (secded_encode_words, secded_scrub_words),
    Tier.DECTED: (dected_encode_words, dected_scrub_words),
    Tier.BURST: (burst_encode_words, burst_scrub_words),
}


@functools.lru_cache(maxsize=None)
def _class_rates(tier: Tier, strike: str, n_events: int, seed: int,
                 device: torch.device) -> TierOutcomeRates:
    rng = np.random.default_rng((seed, STRIKE_CLASSES.index(strike)))
    rows = n_events
    lo = rng.integers(0, 2 ** 32, (rows, LANES), dtype=np.uint32)
    hi = rng.integers(0, 2 ** 32, (rows, LANES), dtype=np.uint32)
    words, bits = _strike(rng, rows, strike)
    blo, bhi = _flip(lo, hi, words, bits)

    if tier is Tier.NONE:
        return TierOutcomeRates(0.0, 0.0, 1.0)
    clean, bad = _words(lo, hi, device), _words(blo, bhi, device)

    if tier is Tier.PARITY_R:
        _, cnt = parity_check_words(bad, parity_encode_words(clean))
        # parity never repairs: undetected events are consumed corrupt
        n_det = int((cnt > 0).sum())
        return TierOutcomeRates(0.0, n_det / rows, (rows - n_det) / rows)

    if tier is Tier.MIRROR:
        err, _ = parity_check_words(bad, parity_encode_words(clean))
        repaired = torch.where(unpack_bits(err), clean, bad)
        n_c = int((repaired == clean).all(1).sum())
        return TierOutcomeRates(n_c / rows, 0.0, (rows - n_c) / rows)

    encode, scrub = _CODECS[tier]
    words2, _, _, unc = scrub(bad, encode(clean))
    detected = unc > 0
    restored = (words2 == clean).all(1)
    n_c = int((restored & ~detected).sum())
    n_d = int(detected.sum())
    n_s = int((~restored & ~detected).sum())
    return TierOutcomeRates(n_c / rows, n_d / rows, n_s / rows)


def measure_class_rates(tier: Tier, strike: str, n_events: int = 128,
                        seed: int = 0, device=None) -> TierOutcomeRates:
    """Conditional outcome rates for one tier under one strike class,
    measured through the tier's kernels (one event per packed row) on
    ``device``: the card unless given."""
    return _class_rates(tier, strike, n_events, seed,
                        resolve_device(device))


def measured_outcome_rates(tier: Tier, multi_bit_fraction: float,
                           adjacent_fraction: float, n_events: int = 128,
                           seed: int = 0, device=None) -> TierOutcomeRates:
    """Outcome rates under the incident-error mix: measured per class,
    mixed analytically (importance stratification over the rare classes)."""
    single, rand2, adj2 = (
        measure_class_rates(tier, strike, n_events, seed, device)
        for strike in STRIKE_CLASSES)
    multi = rand2.mix(adj2, adjacent_fraction)
    return single.mix(multi, multi_bit_fraction)


def measured_tier_rates(tiers: Iterable[Tier], multi_bit_fraction: float,
                        adjacent_fraction: float, n_events: int = 128,
                        seed: int = 0, device=None
                        ) -> Dict[Tier, TierOutcomeRates]:
    return {t: measured_outcome_rates(t, multi_bit_fraction,
                                      adjacent_fraction, n_events, seed,
                                      device)
            for t in set(tiers)}

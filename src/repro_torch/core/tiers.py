"""Reliability tiers — the hardware dimension of the HRM design space.

Mirrors Table 1 of the paper. Each tier's capacity overhead is realized
*for real* by the tier-batched sidecar buffers of
``core.domain.MemoryDomain``: parity packs 1 bit per 64-bit word (1.6%), SEC-DED stores the
8-bit Hsiao(72,64) code per word (12.5%), DEC-TED the 15-bit shortened-BCH
(79,64) code, BURST the 14-bit interleaved SEC-DAEC code, MIRROR a full
second copy (100% + its own parity). ``capacity_overhead`` is the
*code-bit* premium (what a DIMM would provision — the paper's Table 1
column); ``stored_overhead`` is the measured sidecar-byte footprint of our
packed representation (DEC-TED/BURST round 15/14 bits up to a uint16 lane).
See docs/DESIGN.md §2.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class Tier(enum.Enum):
    NONE = "none"              # no detection, no correction
    PARITY_R = "parity_r"      # parity detect + software reload (Par+R)
    SECDED = "secded"          # Hsiao(72,64): correct 1, detect 2 / 64b
    BURST = "burst"            # SEC-DAEC(78,64): correct 1 + any adjacent
                               #   double (interleaved 2x BCH t=1 + parity)
    DECTED = "dected"          # BCH(79,64)+parity: correct 2, detect 3 / 64b
    MIRROR = "mirror"          # full replica + parity: tolerates any word loss


@dataclass(frozen=True)
class TierInfo:
    detect: str
    correct: str
    capacity_overhead: float   # code-bit premium (fraction of data bits)
    added_logic: str           # qualitative, from Table 1
    corrects_single_bit: bool
    detects_single_bit: bool
    detects_double_bit: bool
    corrects_double_bit: bool
    corrects_adjacent_double: bool = False
    code_bits: int = 0         # check bits per 64-bit word (0 = n/a)
    stored_overhead: float = 0.0  # measured sidecar bytes / payload bytes


TIER_TABLE = {
    Tier.NONE: TierInfo("none", "none", 0.0, "none",
                        False, False, False, False),
    Tier.PARITY_R: TierInfo("n/64 bits (odd n)", "software reload", 1.0 / 64,
                            "low", False, True, False, False,
                            code_bits=1, stored_overhead=1.0 / 64),
    Tier.SECDED: TierInfo("2/64 bits", "1/64 bits", 8.0 / 64, "low",
                          True, True, True, False,
                          code_bits=8, stored_overhead=8.0 / 64),
    Tier.BURST: TierInfo("2/39 bits per sub-code", "1 + adjacent 2 / 64 bits",
                         14.0 / 64, "low",
                         True, True, True, False,
                         corrects_adjacent_double=True,
                         code_bits=14, stored_overhead=16.0 / 64),
    Tier.DECTED: TierInfo("3/79 bits", "2/79 bits (data or check)",
                          15.0 / 64, "medium",
                          True, True, True, True,
                          corrects_adjacent_double=True,
                          code_bits=15, stored_overhead=16.0 / 64),
    Tier.MIRROR: TierInfo("replica compare", "replica copy", 1.0 + 1.0 / 64,
                          "low", True, True, True, True,
                          corrects_adjacent_double=True,
                          stored_overhead=1.0 + 1.0 / 64),
}


def capacity_overhead(tier: Tier) -> float:
    return TIER_TABLE[tier].capacity_overhead


def stored_overhead(tier: Tier) -> float:
    return TIER_TABLE[tier].stored_overhead

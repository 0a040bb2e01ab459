"""Cost model of the port: ``RegionProfile``, the measured byte fraction of
each region that ``MemoryDomain.region_profile`` returns. The Fig. 5
pricing of ``repro.core.costmodel`` comes with a later slice."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping


@dataclass(frozen=True)
class RegionProfile:
    """Byte fraction of each region in one application's memory."""
    fractions: Mapping[str, float]

    def frac(self, region: str) -> float:
        return self.fractions.get(region, 0.0)

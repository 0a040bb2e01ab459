"""Memory-error outcome taxonomy (Fig. 1 of the paper).

A copy of ``repro.core.taxonomy``. Mutually exclusive and exhaustive: an
injected error is either never consumed (overwritten before any read ->
MASKED_OVERWRITE), or consumed and then (a) masked by application logic,
(b) visible as an incorrect response, or (c) fatal (crash / NaN divergence
/ runtime fault).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict


class Outcome(enum.Enum):
    MASKED_OVERWRITE = "masked_overwrite"
    MASKED_LOGIC = "masked_by_logic"
    INCORRECT = "incorrect_output"
    CRASH = "crash"


@dataclass
class OutcomeStats:
    counts: Dict[Outcome, int]

    @classmethod
    def zero(cls) -> "OutcomeStats":
        return cls({o: 0 for o in Outcome})

    def add(self, outcome: Outcome, n: int = 1) -> None:
        self.counts[outcome] += n

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def prob(self, outcome: Outcome) -> float:
        t = self.total
        return self.counts[outcome] / t if t else 0.0

    @property
    def crash_prob(self) -> float:
        return self.prob(Outcome.CRASH)

    @property
    def incorrect_prob(self) -> float:
        return self.prob(Outcome.INCORRECT)

    @property
    def tolerance(self) -> float:
        """Paper definition: P(masked), by overwrite or by logic."""
        return (self.prob(Outcome.MASKED_OVERWRITE)
                + self.prob(Outcome.MASKED_LOGIC))

    @property
    def vulnerability(self) -> float:
        """Paper definition: P(incorrect or crash)."""
        return self.prob(Outcome.INCORRECT) + self.prob(Outcome.CRASH)

    def __repr__(self) -> str:
        body = ", ".join(f"{o.value}={self.counts[o]}" for o in Outcome)
        return f"OutcomeStats({body})"

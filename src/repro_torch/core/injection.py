"""Controlled error injection into nested-dict states (the Fig. 2
framework, steps 1-2).

Counterpart of ``repro.core.injection``. An ``Injector`` owns a set of
live errors. Soft errors flip once; hard errors are *sticky*: they
re-assert after every program write to the location (emulating a damaged
cell), which the injector realizes by re-applying the flip after every
step/scrub. Plans are drawn on the host from a numpy generator
(``InjectionPlan.sample``), so a seed gives the reference's strikes; the
flips go through ``kernels.ops.inject_bitflips``, the bit-flip kernel on
the card.

.. deprecated::
    ``Injector`` re-indexes the state on every strike. New code should use
    ``core.domain.MemoryDomain.inject``, which owns the hard-error map and
    re-asserts sticky cells via ``domain.reassert_hard()``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.errormodel import (DEFAULT_ADJACENT_FRACTION,
                                         DEFAULT_MULTI_BIT_FRACTION,
                                         InjectionPlan)
from repro_torch.core.sidecar import _set_leaf, leaf_index
from repro_torch.kernels import ops


@dataclass
class LiveError:
    path: str
    plan: InjectionPlan


@dataclass
class Injector:
    rng: np.random.Generator
    live: List[LiveError] = field(default_factory=list)

    @classmethod
    def seeded(cls, seed: int) -> "Injector":
        return cls(np.random.default_rng(seed))

    def sample_into(self, state, path: str, n_errors: int = 1,
                    hard: bool = False,
                    multi_bit_fraction: float = DEFAULT_MULTI_BIT_FRACTION,
                    adjacent_fraction: float = DEFAULT_ADJACENT_FRACTION,
                    root: str = "params"):
        """Sample a plan for leaf ``path`` and apply it. Returns new state."""
        leaf = leaf_index(state, root)[path]["leaf"]
        plan = InjectionPlan.sample(self.rng, ops.words_per_tensor(leaf),
                                    n_errors, hard, multi_bit_fraction,
                                    adjacent_fraction)
        if hard:
            self.live.append(LiveError(path, plan))
        return self.apply_plan(state, path, plan)

    @staticmethod
    def apply_plan(state, path: str, plan: InjectionPlan):
        leaf = leaf_index(state)[path]["leaf"]
        flipped = ops.inject_bitflips(
            leaf, torch.as_tensor(plan.word_idx, device=leaf.device),
            torch.as_tensor(plan.bit_idx, device=leaf.device))
        return _set_leaf(state, path, flipped)

    def reassert_hard(self, state):
        """Re-apply all sticky errors (call after every write/scrub)."""
        for err in self.live:
            state = self.apply_plan(state, err.path, err.plan)
        return state

    def clear(self, path: Optional[str] = None):
        if path is None:
            self.live = []
        else:
            self.live = [e for e in self.live if e.path != path]

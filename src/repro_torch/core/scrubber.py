"""Scrub scheduling: background scrubbing of one root's per-leaf sidecar.

Counterpart of ``repro.core.scrubber``.

.. deprecated::
    ``Scrubber`` drives the legacy per-leaf scrub over a single root. Use
    ``core.domain.MemoryDomain`` instead: ``domain.scrub(step)`` covers the
    schedule, ``domain.refresh(state)`` the write path, with tier-batched
    kernels. ``Scrubber.create`` warns once, as the reference's does.

A framework-level sidecar cannot intercept loads, so protection is
realized as a *scrub pass* run every ``policy.scrub_interval`` steps (and
on demand before checkpoints). ``stride`` bounds per-pass cost by
round-robining the protected leaves: with stride=s each pass touches ~1/s
of them, trading detection latency for overhead.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.core.policy import HRMPolicy
from repro_torch.core.sidecar import ScrubReport, build_sidecar, scrub


@dataclass
class Scrubber:
    policy: HRMPolicy
    sidecar: Dict
    root: str = "params"
    stride: int = 1
    _pass_idx: int = 0
    history: list = field(default_factory=list)

    @classmethod
    def create(cls, state, policy: HRMPolicy, root: str = "params",
               stride: int = 1) -> "Scrubber":
        warnings.warn(
            "Scrubber is the legacy per-leaf scrub loop; use "
            "repro_torch.core.domain.MemoryDomain (scrub/refresh) instead",
            DeprecationWarning, stacklevel=2)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            sidecar = build_sidecar(state, policy, root)
        return cls(policy, sidecar, root, stride)

    def _subset(self) -> Dict:
        if self.stride <= 1:
            return self.sidecar
        keys = sorted(self.sidecar)
        sel = {k for i, k in enumerate(keys)
               if i % self.stride == self._pass_idx % self.stride}
        return {k: v for k, v in self.sidecar.items() if k in sel}

    def maybe_scrub(self, step: int, state
                    ) -> Tuple[object, Optional[ScrubReport]]:
        if self.policy.scrub_interval <= 0 or \
                step % self.policy.scrub_interval != 0:
            return state, None
        return self.scrub_now(state)

    def scrub_now(self, state) -> Tuple[object, ScrubReport]:
        subset = self._subset()
        with warnings.catch_warnings():
            # the shim warned once at create; don't re-warn per pass
            warnings.simplefilter("ignore", DeprecationWarning)
            state, new_entries, report = scrub(state, subset, self.policy,
                                               self.root)
        self.sidecar.update(new_entries)
        self._pass_idx += 1
        self.history.append(report.totals())
        return state, report

    def refresh(self, state, paths=None) -> None:
        """Re-encode sidecar entries after legitimate writes (e.g. after an
        optimizer update or a clean-copy reload)."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            fresh = build_sidecar(state, self.policy, self.root)
        if paths is None:
            self.sidecar = fresh
        else:
            for p in paths:
                if p in fresh:
                    self.sidecar[p] = fresh[p]

"""Scrub reports: per-path corrected and detected-uncorrectable counts.

Counterpart of ``ScrubReport`` and ``_path_str`` in
``repro.core.sidecar``. The legacy per-leaf sidecar functions are not
ported: ``core.domain.MemoryDomain`` owns the sidecars.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Tuple

import torch


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _host_counts(values) -> list:
    """Counts (0-d tensors or ints) -> Python ints with one device sync."""
    if not values:
        return []
    return torch.stack([torch.as_tensor(v, dtype=torch.int64)
                        for v in values]).tolist()


@dataclass
class ScrubReport:
    corrected: Dict[str, Any] = field(default_factory=dict)
    detected_uncorrectable: Dict[str, Any] = field(default_factory=dict)

    def totals(self) -> Tuple[int, int]:
        """(n_corrected, n_detected_uncorrectable), fetched with one sync."""
        n_c = len(self.corrected)
        counts = _host_counts(list(self.corrected.values())
                              + list(self.detected_uncorrectable.values()))
        return sum(counts[:n_c]), sum(counts[n_c:])

    def needs_recovery(self) -> Dict[str, int]:
        keys = list(self.detected_uncorrectable)
        counts = _host_counts([self.detected_uncorrectable[k] for k in keys])
        return {k: n for k, n in zip(keys, counts) if n > 0}

    @classmethod
    def merged(cls, reports: Iterable["ScrubReport"]) -> "ScrubReport":
        """Aggregate per-shard (or per-replica) reports into one: counts
        sum per path, folded on the host with one device sync per report
        (the reports may lie on different devices of a mesh)."""
        corr: Dict[str, int] = {}
        unc: Dict[str, int] = {}
        for rep in reports:
            n_c = len(rep.corrected)
            counts = _host_counts(list(rep.corrected.values())
                                  + list(rep.detected_uncorrectable.values()))
            for out, keys, ns in ((corr, rep.corrected, counts[:n_c]),
                                  (unc, rep.detected_uncorrectable,
                                   counts[n_c:])):
                for k, n in zip(keys, ns):
                    out[k] = out.get(k, 0) + n
        return cls(corrected=corr, detected_uncorrectable=unc)

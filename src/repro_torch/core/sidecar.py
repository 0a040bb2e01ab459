"""Scrub reports, and the legacy per-leaf sidecar API.

Counterpart of ``repro.core.sidecar``. ``ScrubReport`` is shared with
``core.domain.MemoryDomain``, which owns the sidecars of new code.

.. deprecated::
    ``build_sidecar``/``scrub`` are the legacy *per-leaf* path, kept for
    callers of the reference's API: one kernel launch per leaf and tier,
    where ``MemoryDomain.protect`` / ``scrub`` launch one per tier. Each
    warns once at entry with the reference's ``DeprecationWarning``.

``build_sidecar(state, policy, root)`` walks a nested-dict state,
classifies each leaf into an HRM region, and materializes that region's
tier (the ``kernels/ops.py`` per-leaf wrappers, so the card runs the CUDA
kernels):

  NONE      -> nothing stored
  PARITY_R  -> packed parity bits (1.6% of leaf bytes)
  SECDED    -> ECC byte per 64-bit word (12.5%)
  BURST     -> 14-bit interleaved SEC-DAEC code per word, stored uint16
  DECTED    -> 15-bit shortened-BCH(79,64)+parity code per word, stored
               uint16
  MIRROR    -> full replica + parity on the primary

``scrub(state, sidecar, policy, root)`` re-verifies every protected leaf,
corrects what the tier can correct, and returns (new_state, new_sidecar,
ScrubReport). The sidecar is a flat ``{path: entry}`` dict of tensors.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Tuple

import torch

from repro_torch.core import tree
from repro_torch.core.policy import HRMPolicy, classify_path
from repro_torch.core.tiers import Tier
from repro_torch.kernels import ops

PathEntries = Dict[str, Any]


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


# ------------------------------------------------ legacy per-leaf path
def leaf_index(state, root: str = "params") -> Dict[str, Dict[str, Any]]:
    """{path_str: {"region", "leaf"}} for every tensor leaf."""
    flat, _ = tree.flatten_with_path(state)
    return {_path_str(path): {"region": classify_path(path, root),
                              "leaf": leaf} for path, leaf in flat}


def build_sidecar(state, policy: HRMPolicy, root: str = "params"
                  ) -> PathEntries:
    warnings.warn(
        "build_sidecar is the legacy per-leaf path; use "
        "repro_torch.core.domain.MemoryDomain.protect instead",
        DeprecationWarning, stacklevel=2)
    sc: PathEntries = {}
    for pstr, info in leaf_index(state, root).items():
        tier = policy.tier_of(info["region"])
        leaf = info["leaf"]
        if tier == Tier.NONE:
            continue
        if tier == Tier.PARITY_R:
            sc[pstr] = {"tier": tier.value, "par": ops.parity_encode(leaf)}
        elif tier == Tier.SECDED:
            sc[pstr] = {"tier": tier.value, "ecc": ops.secded_encode(leaf)}
        elif tier == Tier.DECTED:
            sc[pstr] = {"tier": tier.value, "ecc": ops.dected_encode(leaf)}
        elif tier == Tier.BURST:
            sc[pstr] = {"tier": tier.value, "ecc": ops.burst_encode(leaf)}
        elif tier == Tier.MIRROR:
            sc[pstr] = {"tier": tier.value, "copy": leaf,
                        "par": ops.parity_encode(leaf)}
        else:
            raise ValueError(tier)
    return sc


def _set_leaf(state, pstr: str, value):
    """``state`` with the leaf at path string ``pstr`` replaced."""
    flat, treedef = tree.flatten_with_path(state)
    return tree.unflatten(treedef, [
        value if _path_str(path) == pstr else leaf for path, leaf in flat])


def scrub(state, sidecar: PathEntries, policy: HRMPolicy,
          root: str = "params"):
    """Verify + correct every protected leaf. Returns (state', sidecar',
    ScrubReport)."""
    warnings.warn(
        "scrub is the legacy per-leaf path; use "
        "repro_torch.core.domain.MemoryDomain.scrub instead",
        DeprecationWarning, stacklevel=2)
    codecs = {Tier.SECDED: ops.secded_scrub, Tier.DECTED: ops.dected_scrub,
              Tier.BURST: ops.burst_scrub}
    report = ScrubReport()
    idx = leaf_index(state, root)
    new_leaves: Dict[str, Any] = {}
    new_sc: PathEntries = {}
    for pstr, entry in sidecar.items():
        leaf = idx[pstr]["leaf"]
        tier = Tier(entry["tier"])
        if tier == Tier.PARITY_R:
            report.detected_uncorrectable[pstr] = ops.parity_check(
                leaf, entry["par"])
            new_sc[pstr] = entry
        elif tier in codecs:
            leaf2, ecc2, corr, unc = codecs[tier](leaf, entry["ecc"])
            new_leaves[pstr] = leaf2
            new_sc[pstr] = {"tier": entry["tier"], "ecc": ecc2}
            report.corrected[pstr] = corr
            report.detected_uncorrectable[pstr] = unc
        elif tier == Tier.MIRROR:
            mask = ops.parity_error_words(leaf, entry["par"])
            new_leaves[pstr] = ops.restore_words(leaf, entry["copy"], mask)
            new_sc[pstr] = {"tier": entry["tier"], "copy": entry["copy"],
                            "par": entry["par"]}
            report.corrected[pstr] = mask.sum(dtype=torch.int32)
            report.detected_uncorrectable[pstr] = torch.zeros(
                (), dtype=torch.int32, device=leaf.device)
        else:
            raise ValueError(tier)

    for pstr, leaf2 in new_leaves.items():
        state = _set_leaf(state, pstr, leaf2)
    return state, new_sc, report


def sidecar_bytes(sidecar: PathEntries) -> int:
    """Measured capacity overhead in bytes (feeds the cost model)."""
    return sum(v.numel() * v.element_size() for entry in sidecar.values()
               for k, v in entry.items() if k != "tier")


def state_bytes(state) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree.leaves(state))

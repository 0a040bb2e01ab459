"""Cost model: Table 1 capacities and the Fig. 5 server-cost comparison.

Counterpart of ``repro.core.costmodel``. Two parameter sets feed one model:

* ``WEBSEARCH``: the paper-calibrated constants that reproduce the
  published Fig. 5 numbers (Detect&Recover saves 9.7 % memory / 2.9 %
  server cost, Detect&Recover/L 15.5 % / 4.7 %, both at >= 99.90 %
  availability); docs/DESIGN.md §8.1 gives each constant's provenance.
* measured mode: region byte fractions of a real state (``region_fractions``
  over nested dicts of tensors, ``MemoryDomain.region_profile`` for a live
  domain), so the same machinery prices policies for other workloads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping

from repro_torch.core import tree
from repro_torch.core.policy import HRMPolicy, classify_path
from repro_torch.core.tiers import Tier, capacity_overhead

ECC_PREMIUM = 0.125
PARITY_PREMIUM = 1.0 / 64
MEMORY_COST_SHARE = 0.30
TESTING_DISCOUNT = 0.135


@dataclass(frozen=True)
class RegionProfile:
    """Byte fraction of each region in one application's memory."""
    fractions: Mapping[str, float]

    def frac(self, region: str) -> float:
        return self.fractions.get(region, 0.0)


WEBSEARCH = RegionProfile({
    "private": 0.76, "heap": 0.225, "stack": 0.005, "other": 0.01})

# region classes of the paper's design points, expressed over WebSearch's
# regions; ML-workload policies use the REGIONS of core.policy directly.
_PAPER_POLICIES: Dict[str, Dict[str, Tier]] = {
    "typical_server": {r: Tier.SECDED for r in WEBSEARCH.fractions},
    "consumer_pc": {r: Tier.NONE for r in WEBSEARCH.fractions},
    "detect_recover": {"private": Tier.PARITY_R, "heap": Tier.PARITY_R,
                       "stack": Tier.PARITY_R, "other": Tier.NONE},
    "less_tested": {r: Tier.SECDED for r in WEBSEARCH.fractions},
    "detect_recover_l": {"private": Tier.SECDED, "heap": Tier.PARITY_R,
                         "stack": Tier.PARITY_R, "other": Tier.NONE},
    # strong-ECC extensions beyond the paper's five: priced with the real
    # sidecar code-bit widths (tiers.capacity_overhead), availability
    # measured through the DEC-TED / BURST kernels
    # (eccmeasure.measured_tier_rates) rather than calibrated
    "dected_server": {r: Tier.DECTED for r in WEBSEARCH.fractions},
    "burst_dr_l": {"private": Tier.BURST, "heap": Tier.PARITY_R,
                   "stack": Tier.BURST, "other": Tier.NONE},
    "mirror_dr_l": {"private": Tier.MIRROR, "heap": Tier.PARITY_R,
                    "stack": Tier.MIRROR, "other": Tier.NONE},
    # replication-aware two-tier point: a live data-parallel replica is
    # the strong tier, so local ECC drops to parity detect on every
    # protected region and detected errors recover by in-memory peer copy
    "peer_dr_l": {"private": Tier.PARITY_R, "heap": Tier.PARITY_R,
                  "stack": Tier.PARITY_R, "other": Tier.NONE},
}
_LESS_TESTED = {"less_tested", "detect_recover_l", "burst_dr_l",
                "mirror_dr_l", "peer_dr_l"}
# design points with the software recovery layer (Table 2): a
# detected-uncorrectable error is a clean-copy reload, not a machine check
_SOFTWARE_RESPONSE = {"detect_recover", "detect_recover_l", "consumer_pc",
                      "burst_dr_l", "mirror_dr_l", "peer_dr_l"}
# design points whose ECC outcomes come from kernel measurement
_MEASURED_ECC = {"dected_server", "burst_dr_l", "mirror_dr_l"}
# design points whose software recoveries are in-memory replica gathers
# billed PEER_COPY_SECONDS instead of a disk reload
_PEER_RECOVERY = {"peer_dr_l"}


def _tier_premium(tier: Tier) -> float:
    if tier == Tier.SECDED:
        return ECC_PREMIUM
    if tier == Tier.PARITY_R:
        return PARITY_PREMIUM
    if tier == Tier.NONE:
        return 0.0
    return capacity_overhead(tier)


def memory_cost(policy_by_region: Mapping[str, Tier],
                profile: RegionProfile, less_tested: bool) -> float:
    """Relative memory cost (typical ECC server = 1 + ECC_PREMIUM base)."""
    cap = 1.0
    for region, tier in policy_by_region.items():
        cap += profile.frac(region) * _tier_premium(tier)
    if less_tested:
        cap *= (1.0 - TESTING_DISCOUNT)
    return cap


@dataclass
class DesignPointCost:
    name: str
    memory_cost_rel: float          # vs the typical (all-ECC) server
    memory_saving: float            # fraction
    server_saving: float            # fraction of server capital cost

    def row(self) -> str:
        return (f"{self.name:18s} mem_saving={self.memory_saving:6.2%} "
                f"server_saving={self.server_saving:6.2%}")


def paper_design_costs() -> Dict[str, DesignPointCost]:
    base = memory_cost(_PAPER_POLICIES["typical_server"], WEBSEARCH, False)
    out = {}
    for name, pol in _PAPER_POLICIES.items():
        c = memory_cost(pol, WEBSEARCH, name in _LESS_TESTED)
        saving = 1.0 - c / base
        out[name] = DesignPointCost(name, c / base, saving,
                                    saving * MEMORY_COST_SHARE)
    return out


# ------------------------------------------------ measured (ML workloads)
def region_fractions(state, root: str = "params") -> RegionProfile:
    """Byte fraction per HRM region, measured from a real state (nested
    dicts of tensors), every leaf classified under ``root``'s kind."""
    sizes: Dict[str, int] = {}
    for path, leaf in tree.flatten_with_path(state)[0]:
        region = classify_path(path, root)
        sizes[region] = sizes.get(region, 0) + \
            leaf.numel() * leaf.element_size()
    total = sum(sizes.values())
    return RegionProfile({r: b / total for r, b in sizes.items()})


def policy_memory_cost(policy: HRMPolicy, profile: RegionProfile) -> float:
    pol = {r: policy.tier_of(r) for r in profile.fractions}
    return memory_cost(pol, profile, policy.error_model.less_tested)


def policy_cost_saving(policy: HRMPolicy, profile: RegionProfile
                       ) -> DesignPointCost:
    base_pol = {r: Tier.SECDED for r in profile.fractions}
    base = memory_cost(base_pol, profile, False)
    c = policy_memory_cost(policy, profile)
    saving = 1.0 - c / base
    return DesignPointCost(policy.name, c / base, saving,
                           saving * MEMORY_COST_SHARE)

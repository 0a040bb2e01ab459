"""HRM policy auto-tuner (beyond-paper).

Counterpart of ``repro.core.autopolicy``, pure Python over the port's cost
and availability models.

The paper hand-designs five points in the HRM space and suggests the rest
of the space as future work. This module closes the loop the paper opens:
given (a) a *measured* region byte profile (``region_fractions`` on a real
state), (b) a *measured* vulnerability profile (a ``CampaignResult``
from the Fig.2 injection framework), and (c) an availability / incorrect-
rate target, search the per-region tier assignment that meets the target
at minimum memory cost.

The search is exact: regions are independent in both the cost model and
the availability model (the objective and constraints are separable sums),
so per-region we keep the cheapest tier whose *marginal* contribution
keeps the global constraints feasible — evaluated by exhaustive sweep over
the tier set per region, from cheapest up (tiers are totally ordered by
capacity premium and weakly ordered by protection, so the first feasible
completion is optimal).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.core.availability import VulnProfile, evaluate_availability
from repro_torch.core.characterize import CampaignResult
from repro_torch.core.costmodel import RegionProfile, memory_cost
from repro_torch.core.errormodel import ErrorModel
from repro_torch.core.policy import HRMPolicy
from repro_torch.core.tiers import Tier

# search order: cheapest first (capacity premium ascending); BURST (14/64)
# and DEC-TED (15/64) extend the space above SEC-DED for regions whose
# vulnerability cannot be met by single-bit correction
_TIER_ORDER = (Tier.NONE, Tier.PARITY_R, Tier.SECDED, Tier.BURST,
               Tier.DECTED)


@dataclass
class AutoPolicyResult:
    policy: HRMPolicy
    memory_cost_rel: float          # vs all-SEC-DED baseline
    memory_saving: float
    availability: float
    crashes_per_month: float
    incorrect_per_million: float

    def summary(self) -> str:
        tiers = {r: t.value for r, t in self.policy.tiers.items()}
        return (f"saving={self.memory_saving:.2%} "
                f"avail={self.availability:.4%} "
                f"crashes/mo={self.crashes_per_month:.2f} "
                f"bad/M={self.incorrect_per_million:.2f} tiers={tiers}")


def vuln_from_campaign(result: CampaignResult,
                       default_crash: float = 0.1,
                       incorrect_scale: float = 3.0) -> VulnProfile:
    """Convert measured Fig.2 outcomes into the availability model's
    per-region vulnerability profile (incorrect-rate scaled to the
    model's per-consumed-error units)."""
    p_crash: Dict[str, float] = {}
    r_inc: Dict[str, float] = {}
    for region in result.regions():
        p_crash[region] = max(result.crash_prob(region=region), 0.0)
        r_inc[region] = incorrect_scale * result.incorrect_prob(
            region=region)
    return VulnProfile(p_crash=p_crash, r_incorrect=r_inc)


def tune_policy(profile: RegionProfile, vuln: VulnProfile, *,
                availability_target: float = 0.9990,
                incorrect_target_per_million: float = 12.0,
                less_tested: bool = False,
                errors_per_month: Optional[float] = None,
                name: str = "auto") -> AutoPolicyResult:
    """Cheapest region->tier map meeting the targets."""
    regions = sorted(profile.fractions)
    kwargs = dict(less_tested=less_tested, software_response=True)
    if errors_per_month is not None:
        kwargs["errors_per_month"] = errors_per_month

    # start from full protection; relax each region independently to the
    # cheapest tier that keeps BOTH constraints satisfied when every other
    # region stays at its current (already-feasible) assignment.
    assign: Dict[str, Tier] = {r: Tier.SECDED for r in regions}

    def feasible(a: Mapping[str, Tier]) -> Tuple[bool, object]:
        res = evaluate_availability(name, a, profile, vuln, **kwargs)
        ok = (res.availability >= availability_target and
              res.incorrect_per_million <= incorrect_target_per_million)
        return ok, res

    ok, _ = feasible(assign)
    if not ok:
        # escalate the starting point to the strongest tier before giving
        # up — the relax loop below then walks each region back down
        assign = {r: Tier.DECTED for r in regions}
        ok, _ = feasible(assign)
    if not ok:
        raise ValueError("even all-DEC-TED cannot meet the target under "
                         "this error model")

    # regions in descending byte fraction: relax the biggest savings first
    for region in sorted(regions, key=lambda r: -profile.frac(r)):
        for tier in _TIER_ORDER:                 # cheapest upward
            trial = dict(assign)
            trial[region] = tier
            ok, _ = feasible(trial)
            if ok:
                assign = trial
                break

    _, res = feasible(assign)
    base = memory_cost({r: Tier.SECDED for r in regions}, profile, False)
    cost = memory_cost(assign, profile, less_tested)
    policy = HRMPolicy(name, assign, default=Tier.NONE,
                       error_model=ErrorModel(less_tested=less_tested))
    return AutoPolicyResult(
        policy=policy,
        memory_cost_rel=cost / base,
        memory_saving=1.0 - cost / base,
        availability=res.availability,
        crashes_per_month=res.crashes_per_month,
        incorrect_per_million=res.incorrect_per_million,
    )


def tune_policy_for_domain(domain, vuln, **kwargs) -> AutoPolicyResult:
    """Tune a policy for a live ``MemoryDomain``: the region byte profile
    is *measured* from the domain's own leaf table (all roots included),
    so a multi-root domain (params + optimizer moments + KV cache) is
    tuned over exactly the bytes it protects.

    ``vuln`` is a ``VulnProfile`` or a ``CampaignResult`` (converted via
    ``vuln_from_campaign``). Returns the same ``AutoPolicyResult`` as
    ``tune_policy``; re-protect with
    ``MemoryDomain.protect(domain.state, result.policy)``.
    """
    if isinstance(vuln, CampaignResult):
        vuln = vuln_from_campaign(vuln)
    return tune_policy(domain.region_profile(), vuln, **kwargs)

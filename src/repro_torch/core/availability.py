"""Single-server availability and incorrect-query model (Fig. 5, right
axis).

Counterpart of ``repro.core.availability``. Event flow for each incident
memory error, by tier of the region it strikes:

  NONE      consumed: crash w.p. p_crash(region), else may surface
            incorrect results at r_incorrect(region) per million queries
  PARITY_R  detected on scrub/access (odd-bit) -> software reload costing
            RECOVERY_SECONDS; even-bit (multi_bit_fraction) escapes ->
            consumed as above
  SECDED    single-bit corrected silently; double-bit detected-uncorrectable
            -> software reload under an HRM response, or a machine-check
            crash on the homogeneous typical server (no software layer)
  MIRROR/DECTED/BURST  corrected; negligible escape at these rates

Every constant is calibrated; docs/DESIGN.md §8.2 records each value's
provenance and the published Fig. 5 numbers they reproduce.

``evaluate_availability`` also takes measured per-tier outcome rates
(``core.eccmeasure.TierOutcomeRates``): when ``tier_rates`` has an entry for
a region's tier, the calibrated branch is replaced by the rates obtained by
driving that tier's kernels. Corrected events vanish, detected events
become software reloads (or machine-check crashes without a software
layer), silent events are consumed like unprotected ones.

``replay_availability`` is the trace-driven twin: outcome rates from
replaying a recorded error stream (``core.trace``) event by event.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import numpy as np

from repro_torch.core.costmodel import (_LESS_TESTED, _MEASURED_ECC,
                                        _PAPER_POLICIES, _PEER_RECOVERY,
                                        _SOFTWARE_RESPONSE, WEBSEARCH,
                                        RegionProfile)
from repro_torch.core.eccmeasure import TierOutcomeRates
from repro_torch.core.tiers import Tier

ERRORS_PER_SERVER_MONTH = 540.0
LESS_TESTED_RATE_FACTOR = 1.5
MULTI_BIT_FRACTION = 0.002
CRASH_MTTR_MIN = 10.0          # restart + warmup
RECOVERY_SECONDS = 2.0         # reload a region's clean copy from disk
# in-memory gather from a live data-parallel replica (Response.PEER_COPY):
# a cross-host device-to-device copy, ~40x cheaper than the disk reload
# (arXiv:2309.00304's replication-aware recovery path)
PEER_COPY_SECONDS = 0.05
# fraction of detected-uncorrectable events where every replica of the
# flagged shard is simultaneously dirty, forcing the disk fallback
# (independent per-replica strike odds within one scrub interval)
PEER_FALLBACK_FRACTION = 1e-3
MINUTES_PER_MONTH = 30 * 24 * 60


@dataclass(frozen=True)
class VulnProfile:
    """Measured (or paper-calibrated) per-region vulnerability."""
    p_crash: Mapping[str, float]          # P(crash | error consumed)
    r_incorrect: Mapping[str, float]      # incorrect per M queries per
                                          # consumed error


WEBSEARCH_VULN = VulnProfile(
    p_crash={"private": 0.05, "heap": 0.15, "stack": 0.50, "other": 0.20},
    r_incorrect={"private": 3.0, "heap": 1.0, "stack": 0.1, "other": 1.5},
)


@dataclass
class AvailabilityResult:
    name: str
    crashes_per_month: float
    recoveries_per_month: float     # disk reloads (RECOVERY_SECONDS each)
    incorrect_per_million: float
    downtime_min_per_month: float
    availability: float
    # in-memory replica gathers (PEER_COPY_SECONDS each) — billed
    # separately from disk reloads so peer recovery is visible in the row
    peer_recoveries_per_month: float = 0.0

    def row(self) -> str:
        return (f"{self.name:18s} avail={self.availability:8.4%} "
                f"crashes/mo={self.crashes_per_month:5.2f} "
                f"incorrect/M={self.incorrect_per_million:5.2f} "
                f"recoveries/mo={self.recoveries_per_month:7.1f} "
                f"peer/mo={self.peer_recoveries_per_month:7.1f}")


def evaluate_availability(name: str,
                          tiers_by_region: Mapping[str, Tier],
                          profile: RegionProfile,
                          vuln: VulnProfile,
                          *,
                          less_tested: bool = False,
                          software_response: bool = True,
                          peer_recovery: bool = False,
                          errors_per_month: float = ERRORS_PER_SERVER_MONTH,
                          tier_rates: Optional[Mapping[
                              Tier, TierOutcomeRates]] = None,
                          ) -> AvailabilityResult:
    """``peer_recovery=True`` models a design with a live data-parallel
    replica (``Response.PEER_COPY``): detected-uncorrectable software
    recoveries are in-memory replica gathers charged ``PEER_COPY_SECONDS``
    — except the ``PEER_FALLBACK_FRACTION`` where every replica of the
    shard is dirty and the disk reload (``RECOVERY_SECONDS``) fires."""
    e_total = errors_per_month * (LESS_TESTED_RATE_FACTOR if less_tested
                                  else 1.0)
    crashes = 0.0
    recoveries = 0.0
    peer_recoveries = 0.0

    def _recover(detected: float) -> None:
        nonlocal recoveries, peer_recoveries
        if peer_recovery:
            peer_recoveries += detected * (1.0 - PEER_FALLBACK_FRACTION)
            recoveries += detected * PEER_FALLBACK_FRACTION
        else:
            recoveries += detected

    incorrect = 0.0
    for region, frac in profile.fractions.items():
        e = e_total * frac
        tier = tiers_by_region.get(region, Tier.NONE)
        pc = vuln.p_crash.get(region, 0.1)
        ri = vuln.r_incorrect.get(region, 1.0)
        rates = tier_rates.get(tier) if tier_rates else None
        if rates is not None:
            # measured branch: outcome rates from the tier's real kernels
            detected = e * rates.detected
            if software_response or tier == Tier.PARITY_R:
                _recover(detected)       # Par+R always implies the reload
            else:
                crashes += detected      # machine-check on typical HW
            consumed = e * rates.silent
        elif tier == Tier.NONE:
            consumed = e
        elif tier == Tier.PARITY_R:
            detected = e * (1.0 - MULTI_BIT_FRACTION)
            _recover(detected)
            consumed = e * MULTI_BIT_FRACTION
        elif tier == Tier.SECDED:
            ue = e * MULTI_BIT_FRACTION        # detected-uncorrectable
            if software_response:
                _recover(ue)
            else:
                crashes += ue                   # machine-check on typical HW
            consumed = 0.0
        else:                                   # DECTED / BURST / MIRROR
            consumed = 0.0
        crashes += consumed * pc
        incorrect += consumed * (1.0 - pc) * ri
    downtime = (crashes * CRASH_MTTR_MIN
                + recoveries * RECOVERY_SECONDS / 60.0
                + peer_recoveries * PEER_COPY_SECONDS / 60.0)
    avail = 1.0 - downtime / MINUTES_PER_MONTH
    return AvailabilityResult(name, crashes, recoveries, incorrect,
                              downtime, avail, peer_recoveries)


_HASH_MUL = np.uint64(0x9E3779B97F4A7C15)


def _event_unit(trace, salt: int) -> "np.ndarray":
    """Deterministic per-event uniform in [0,1) from (dimm, addr, index).

    Pure arithmetic over the trace arrays — replaying the same trace
    always makes the same region/crash decisions, which is what makes
    ``replay_availability`` reproducible run-to-run."""
    x = (trace.addr.astype(np.uint64)
         + (trace.dimm.astype(np.uint64) << np.uint64(40))
         + (np.arange(len(trace), dtype=np.uint64) << np.uint64(52))
         + np.uint64(salt))
    x = (x ^ (x >> np.uint64(30))) * _HASH_MUL
    x = x ^ (x >> np.uint64(27))
    return (x >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def _burst_outcome(tier: Tier, width: int) -> str:
    """Deterministic outcome of one adjacent burst of ``width`` bits under
    ``tier`` — the same word-level contracts the ECC conformance suite
    proves for the real kernels (tests/ecc_conformance.py)."""
    if tier == Tier.NONE:
        return "consumed"
    if tier == Tier.PARITY_R:
        # parity sees odd flip counts; even-width bursts escape silently
        return "detected" if width % 2 == 1 else "consumed"
    if tier == Tier.SECDED:
        if width == 1:
            return "corrected"
        return "detected" if width == 2 else "consumed"
    if tier == Tier.BURST:
        # SEC-DAEC corrects any adjacent pair; wider bursts split across
        # the interleaved sub-codes and flag detected-uncorrectable
        return "corrected" if width <= 2 else "detected"
    if tier == Tier.DECTED:
        if width <= 2:
            return "corrected"
        return "detected" if width == 3 else "consumed"
    if tier == Tier.MIRROR:
        # replica repair is parity-directed: even-width bursts escape the
        # compare (same contract the measured MIRROR rates show)
        return "corrected" if width % 2 == 1 else "consumed"
    raise ValueError(tier)


def replay_availability(name: str,
                        tiers_by_region: Mapping[str, Tier],
                        profile: RegionProfile,
                        vuln: VulnProfile,
                        trace,
                        *,
                        software_response: bool = True,
                        peer_recovery: bool = False,
                        tier_rates: Optional[Mapping[
                            Tier, TierOutcomeRates]] = None,
                        seed: int = 0) -> AvailabilityResult:
    """``evaluate_availability``'s trace-driven twin: outcome rates from
    replaying a recorded error stream (``core.trace.ErrorTrace``) instead
    of the analytic iid incident budget.

    Each event lands in a region (deterministically, byte-weighted by the
    profile via a per-event hash), meets its region's tier, and resolves
    by its recorded burst width (``_burst_outcome``) — so the correlated
    multi-bit structure of the trace, which the analytic path can only
    summarize as ``MULTI_BIT_FRACTION``, directly shapes the result.
    Consumed events charge crash/incorrect expectations from the
    vulnerability profile. Counts scale by the trace's recorded span to
    per-month rates. ``tier_rates`` substitutes measured kernel outcome
    rates (expectation-weighted) for the burst rules on its tiers.

    Deterministic: same trace + seed -> identical numbers, every run.
    """
    regions = sorted(profile.fractions)
    fracs = np.array([profile.fractions[r] for r in regions])
    cum = np.cumsum(fracs) / max(fracs.sum(), 1e-12)
    u_region = _event_unit(trace, seed)
    region_idx = np.searchsorted(cum, u_region, side="right")
    region_idx = np.minimum(region_idx, len(regions) - 1)

    crashes = recoveries = peer_recoveries = incorrect = 0.0

    def _recover(detected: float) -> None:
        nonlocal recoveries, peer_recoveries
        if peer_recovery:
            peer_recoveries += detected * (1.0 - PEER_FALLBACK_FRACTION)
            recoveries += detected * PEER_FALLBACK_FRACTION
        else:
            recoveries += detected

    for i in range(len(trace)):
        region = regions[int(region_idx[i])]
        tier = tiers_by_region.get(region, Tier.NONE)
        pc = vuln.p_crash.get(region, 0.1)
        ri = vuln.r_incorrect.get(region, 1.0)
        rates = tier_rates.get(tier) if tier_rates else None
        if rates is not None:
            # measured branch: expectation-weighted kernel outcome rates
            if software_response or tier == Tier.PARITY_R:
                _recover(rates.detected)
            else:
                crashes += rates.detected
            consumed = rates.silent
        else:
            outcome = _burst_outcome(tier, int(trace.burst[i]))
            consumed = 0.0
            if outcome == "consumed":
                consumed = 1.0
            elif outcome == "detected":
                if software_response or tier == Tier.PARITY_R:
                    _recover(1.0)
                else:
                    crashes += 1.0
        crashes += consumed * pc
        incorrect += consumed * (1.0 - pc) * ri
    months = max(trace.months, 1e-9)
    crashes /= months
    recoveries /= months
    peer_recoveries /= months
    incorrect /= months
    downtime = (crashes * CRASH_MTTR_MIN
                + recoveries * RECOVERY_SECONDS / 60.0
                + peer_recoveries * PEER_COPY_SECONDS / 60.0)
    avail = 1.0 - downtime / MINUTES_PER_MONTH
    return AvailabilityResult(name, crashes, recoveries, incorrect,
                              downtime, avail, peer_recoveries)


def paper_design_availability(
        tier_rates: Optional[Mapping[Tier, TierOutcomeRates]] = None,
        ) -> Dict[str, AvailabilityResult]:
    """The Fig. 5 design points on the WebSearch profile.

    ``tier_rates`` (when given) applies measured kernel outcome rates to
    the measured-ECC design points (``dected_server``, ``burst_dr_l``,
    ``mirror_dr_l``); the
    five published points always stay on the calibrated branch so the
    pinned paper numbers are untouched.
    """
    out = {}
    for name, pol in _PAPER_POLICIES.items():
        out[name] = evaluate_availability(
            name, pol, WEBSEARCH, WEBSEARCH_VULN,
            less_tested=name in _LESS_TESTED,
            # the homogeneous typical/less-tested servers have no software
            # response layer: an uncorrectable ECC error is a crash
            software_response=name in _SOFTWARE_RESPONSE,
            peer_recovery=name in _PEER_RECOVERY,
            tier_rates=tier_rates if name in _MEASURED_ECC else None,
        )
    return out

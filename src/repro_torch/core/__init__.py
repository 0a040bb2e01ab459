"""Core of the port: tiers, error model, policies, recovery, scrub reports,
the ``MemoryDomain`` verbs, the deprecated per-leaf path (``build_sidecar``
/ ``scrub`` / ``Scrubber`` / ``Injector`` / ``RecoveryManager``, each
warning as the reference's does), sharded domains with peer-copy recovery
(``sharded``), measured per-tier ECC outcome rates
(``eccmeasure``), the Fig. 5 cost and availability models
(``costmodel``/``availability``), the Fig. 2 campaign (``taxonomy``,
``characterize``), the policy auto-tuner (``autopolicy``) and the error
trace engine (``trace``, ``tracegen``)."""
from repro_torch.core.autopolicy import (  # noqa: F401
    AutoPolicyResult, tune_policy, tune_policy_for_domain, vuln_from_campaign,
)
from repro_torch.core.availability import (  # noqa: F401
    PEER_COPY_SECONDS, RECOVERY_SECONDS, WEBSEARCH_VULN, AvailabilityResult,
    VulnProfile, evaluate_availability, paper_design_availability,
    replay_availability,
)
from repro_torch.core.characterize import (  # noqa: F401
    CampaignResult, classify_trial, lm_eval_fn, run_campaign,
    run_trace_campaign,
)
from repro_torch.core.costmodel import (  # noqa: F401
    WEBSEARCH, DesignPointCost, RegionProfile, paper_design_costs,
    policy_cost_saving, region_fractions,
)
from repro_torch.core.domain import (  # noqa: F401
    DomainSpec, DomainStats, LeafSpec, MemoryDomain,
)
from repro_torch.core.eccmeasure import (  # noqa: F401
    TierOutcomeRates, measure_class_rates, measured_outcome_rates,
    measured_tier_rates,
)
from repro_torch.core.errormodel import (  # noqa: F401
    DEFAULT_ADJACENT_FRACTION, DEFAULT_MULTI_BIT_FRACTION, ErrorModel,
    InjectionPlan,
)
from repro_torch.core.injection import Injector  # noqa: F401
from repro_torch.core.policy import (  # noqa: F401
    DESIGN_POINTS, REGIONS, HRMPolicy, burst_dr_l, classify_path,
    dected_server, detect_recover, detect_recover_l, mirror_dr_l,
    peer_dr_l, typical_server,
)
from repro_torch.core.recovery import (  # noqa: F401
    BLOCK_BYTES, RecoveryManager, Response, RestartRequired, RetirementMap,
    flagged_blocks,
)
from repro_torch.core.sharded import (  # noqa: F401
    ShardedMemoryDomain, ShardedScrubReport,
)
from repro_torch.core.scrubber import Scrubber  # noqa: F401
from repro_torch.core.sidecar import (  # noqa: F401
    ScrubReport, build_sidecar, scrub, sidecar_bytes, state_bytes,
)
from repro_torch.core.tiers import Tier  # noqa: F401
from repro_torch.core.taxonomy import Outcome, OutcomeStats  # noqa: F401
from repro_torch.core.trace import (  # noqa: F401
    BoundStrike, ErrorTrace, TraceReplayer, bind_trace,
)
from repro_torch.core.tracegen import (  # noqa: F401
    TraceGenConfig, generate_error_trace,
)

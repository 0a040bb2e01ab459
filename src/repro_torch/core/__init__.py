"""Core of the port: tiers, error model, policies, recovery, scrub reports
and the ``MemoryDomain`` verbs."""
from repro_torch.core.costmodel import RegionProfile  # noqa: F401
from repro_torch.core.domain import (  # noqa: F401
    DomainSpec, DomainStats, LeafSpec, MemoryDomain,
)
from repro_torch.core.errormodel import ErrorModel, InjectionPlan  # noqa: F401
from repro_torch.core.policy import (  # noqa: F401
    DESIGN_POINTS, REGIONS, HRMPolicy, classify_path, detect_recover,
    detect_recover_l, mirror_dr_l, typical_server,
)
from repro_torch.core.recovery import (  # noqa: F401
    BLOCK_BYTES, Response, RestartRequired, RetirementMap, flagged_blocks,
)
from repro_torch.core.sidecar import ScrubReport  # noqa: F401
from repro_torch.core.tiers import Tier  # noqa: F401

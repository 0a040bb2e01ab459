"""HRM policy: the region -> tier mapping plus the evaluated design points.

Counterpart of ``repro.core.policy``. Regions of a job's state are derived
from key paths; a path here is a tuple of plain string keys (the port's
state is nested dicts), where the reference walks ``jax.tree_util`` keys.

    params/embed   token/patch/frame embeddings + LM head
    params/attn    attention projections (incl. shared hybrid block)
    params/mlp     dense MLP weights
    params/experts MoE expert weights (cold, Par+R-friendly)
    params/ssm     Mamba2 / xLSTM mixer weights
    params/norm    norms and other small vectors
    opt/m, opt/v   optimizer moments
    kv_cache       decode KV cache / recurrent states
    activations    transient per-step tensors (advisory only)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Tuple

from repro_torch.core.errormodel import ErrorModel
from repro_torch.core.tiers import Tier

REGIONS = ("params/embed", "params/attn", "params/mlp", "params/experts",
           "params/ssm", "params/norm", "opt/m", "opt/v", "kv_cache",
           "activations", "graph/topology", "graph/rank", "graph/frontier")

_SSM_KEYS = ("mamba", "mlstm", "slstm", "conv_w", "conv_b", "a_log",
             "dt_bias", "d_skip")
_EMBED_KEYS = ("embed", "head", "patch_proj", "frame_proj")
_ATTN_KEYS = ("attn", "wq", "wk", "wv", "wo", "bq", "bk", "bv")
_EXPERT_KEYS = ("moe", "experts", "router")
_GRAPH_TOPO_KEYS = ("topology", "indptr", "indices", "src", "dst", "outdeg")
_GRAPH_FRONTIER_KEYS = ("frontier", "visited", "dist")


def _path_keys(path: Iterable) -> Tuple[str, ...]:
    return tuple(str(k).lower() for k in path)


def classify_path(path, root: str = "params") -> str:
    """Map a key path to an HRM region name."""
    keys = _path_keys(path)
    if root == "opt":
        return "opt/m" if keys and keys[0] in ("m", "mu") else "opt/v"
    if root == "cache":
        return "kv_cache"
    if root == "graph":
        ks = set(keys)
        if ks & set(_GRAPH_TOPO_KEYS):
            return "graph/topology"
        if ks & set(_GRAPH_FRONTIER_KEYS):
            return "graph/frontier"
        return "graph/rank"
    ks = set(keys)
    if ks & set(_EXPERT_KEYS):
        return "params/experts"
    if ks & set(_SSM_KEYS):
        return "params/ssm"
    if any(k in _EMBED_KEYS for k in keys):
        return "params/embed"
    if ks & set(_ATTN_KEYS):
        return "params/attn"
    if any("norm" in k for k in keys):
        return "params/norm"
    return "params/mlp"


@dataclass(frozen=True)
class HRMPolicy:
    """region -> Tier, with a default for unlisted regions."""
    name: str
    tiers: Dict[str, Tier] = field(default_factory=dict)
    default: Tier = Tier.NONE
    error_model: ErrorModel = field(default_factory=ErrorModel)
    scrub_interval: int = 50           # steps between scrub passes

    def tier_of(self, region: str) -> Tier:
        return self.tiers.get(region, self.default)


# ------------------------------------------------------- the design points
def typical_server() -> HRMPolicy:
    """Baseline: SEC-DED homogeneously everywhere (non-HRM)."""
    return HRMPolicy("typical_server",
                     {r: Tier.SECDED for r in REGIONS},
                     default=Tier.SECDED)


def consumer_pc() -> HRMPolicy:
    """No protection anywhere (non-HRM)."""
    return HRMPolicy("consumer_pc", {}, default=Tier.NONE)


def detect_recover() -> HRMPolicy:
    """HRM: Par+R on the long-lived 'private'-like regions, none elsewhere."""
    return HRMPolicy(
        "detect_recover",
        {"params/embed": Tier.PARITY_R, "params/attn": Tier.PARITY_R,
         "params/mlp": Tier.PARITY_R, "params/experts": Tier.PARITY_R,
         "params/ssm": Tier.PARITY_R, "params/norm": Tier.PARITY_R,
         "opt/m": Tier.PARITY_R, "opt/v": Tier.PARITY_R,
         "graph/topology": Tier.PARITY_R, "graph/rank": Tier.PARITY_R,
         "graph/frontier": Tier.PARITY_R},
        default=Tier.NONE)


def less_tested() -> HRMPolicy:
    """SEC-DED everywhere on less-tested devices (non-HRM)."""
    p = typical_server()
    return HRMPolicy("less_tested", dict(p.tiers), default=Tier.SECDED,
                     error_model=ErrorModel(less_tested=True))


def detect_recover_l() -> HRMPolicy:
    """HRM on less-tested devices: SEC-DED on the most vulnerable regions,
    Par+R on the bulky tolerant ones."""
    return HRMPolicy(
        "detect_recover_l",
        {"params/embed": Tier.SECDED, "params/attn": Tier.SECDED,
         "params/norm": Tier.SECDED, "params/ssm": Tier.SECDED,
         "params/mlp": Tier.PARITY_R, "params/experts": Tier.PARITY_R,
         "opt/m": Tier.PARITY_R, "opt/v": Tier.PARITY_R,
         "graph/topology": Tier.SECDED, "graph/rank": Tier.PARITY_R,
         "graph/frontier": Tier.PARITY_R},
        default=Tier.NONE,
        error_model=ErrorModel(less_tested=True))


def dected_server() -> HRMPolicy:
    """Strong homogeneous baseline: DEC-TED everywhere (non-HRM)."""
    return HRMPolicy("dected_server",
                     {r: Tier.DECTED for r in REGIONS},
                     default=Tier.DECTED)


def burst_dr_l() -> HRMPolicy:
    """HRM on less-tested devices with burst-correcting ECC (SEC-DAEC) where
    detect_recover_l used SEC-DED, Par+R on the bulky tolerant regions."""
    base = detect_recover_l()
    tiers = {r: (Tier.BURST if t == Tier.SECDED else t)
             for r, t in base.tiers.items()}
    return HRMPolicy("burst_dr_l", tiers, default=Tier.NONE,
                     error_model=ErrorModel(less_tested=True))


def mirror_dr_l() -> HRMPolicy:
    """HRM on less-tested devices with full mirroring (replica + parity)
    where detect_recover_l used SEC-DED, Par+R on the bulky tolerant
    regions."""
    base = detect_recover_l()
    tiers = {r: (Tier.MIRROR if t == Tier.SECDED else t)
             for r, t in base.tiers.items()}
    return HRMPolicy("mirror_dr_l", tiers, default=Tier.NONE,
                     error_model=ErrorModel(less_tested=True))


def peer_dr_l() -> HRMPolicy:
    """Replication-aware two-tier HRM on less-tested devices: a live
    data-parallel replica is the strong tier, so every region
    detect_recover_l protected drops to Par+R locally."""
    base = detect_recover_l()
    tiers = {r: Tier.PARITY_R for r in base.tiers}
    return HRMPolicy("peer_dr_l", tiers, default=Tier.NONE,
                     error_model=ErrorModel(less_tested=True))


DESIGN_POINTS = {
    "typical_server": typical_server,
    "consumer_pc": consumer_pc,
    "detect_recover": detect_recover,
    "less_tested": less_tested,
    "detect_recover_l": detect_recover_l,
    "dected_server": dected_server,
    "burst_dr_l": burst_dr_l,
    "mirror_dr_l": mirror_dr_l,
    "peer_dr_l": peer_dr_l,
}

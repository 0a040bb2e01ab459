"""Dense MLP blocks (swiglu / relu2 / gelu).

Counterpart of ``repro.models.mlp``'s dense path: the products run in the
compute dtype. The mixture-of-experts path waits for the slice that ports
the other families (ROADMAP.md, queue 1, item 12): ``transformer.forward``
raises ``NotImplementedError`` on a MoE config.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import act_fn, dtype_of


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    h = xc @ p["wi"].to(cdt)
    if cfg.act == "swiglu":
        h = F.silu(h) * (xc @ p["wg"].to(cdt))
    else:
        h = act_fn(cfg.act)(h)
    return h @ p["wo"].to(cdt)


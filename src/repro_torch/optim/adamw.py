"""AdamW over nested-dict state.

Counterpart of ``repro.optim.adamw``, with the same arithmetic in float32:
``count`` is an int32 0-d tensor, the bias corrections ``1 - b**count``
are float32 tensors, the update is ``p - lr * (step + wd * p)``, and the
results are cast back to the parameter and moment dtypes. Global-norm
clipping runs in float32. The update is functional: it returns new
tensors and writes into none it was given.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import tree
from repro_torch.models.common import dtype_of


def adamw_init(params, cfg: ModelConfig) -> Dict[str, Any]:
    mdt = dtype_of(cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)
    count = torch.zeros((), dtype=torch.int32,
                        device=tree.leaves(params)[0].device)
    return {"m": tree.map_leaves(zeros, params),
            "v": tree.map_leaves(zeros, params),
            "count": count}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in float32, the leaves
    added in the reference's (sorted) order."""
    sq = sum(torch.sum(torch.square(x.to(torch.float32)))
             for x in tree.leaves(grads))
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree.map_leaves(
        lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


def adamw_update(params, grads, opt, tcfg: TrainConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """(new params, new opt state, {"grad_norm"})."""
    grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
    count = opt["count"] + 1
    b1, b2 = tcfg.beta1, tcfg.beta2
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)

    def upd(p, g, m, v):
        gf = g.to(torch.float32)
        mf = b1 * m.to(torch.float32) + (1 - b1) * gf
        vf = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
        step = (mf / bc1) / (torch.sqrt(vf / bc2) + tcfg.eps)
        pf = p.to(torch.float32)
        pf = pf - tcfg.lr * (step + tcfg.weight_decay * pf)
        return pf.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)

    flat, treedef = tree.flatten_with_path(params)
    outs = [upd(p, g, m, v) for (_, p), g, m, v in zip(
        flat, tree.leaves(grads), tree.leaves(opt["m"]),
        tree.leaves(opt["v"]))]
    new_params, new_m, new_v = (tree.unflatten(treedef, [o[i] for o in outs])
                                for i in range(3))
    return new_params, {"m": new_m, "v": new_v, "count": count}, \
        {"grad_norm": gnorm}

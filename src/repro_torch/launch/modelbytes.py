"""Analytic per-device HBM-traffic floor (bytes/step).

Counterpart of ``repro.launch.modelbytes``, term for term. The byte count
of ``launch.step_cost`` sums every eager operation's operands and results,
with no fusion at all, so it over-states HBM traffic; this module gives
the transparent first-order floor:

  train:   3x params_local (read fwd / read bwd / write) + grads (w+r)
           + 2x moments (r+w each) + activation stream
           (fwd+bwd tensor traffic per layer ~ 12 residual-sized buffers,
            x2 more when remat recomputes the forward)
  prefill: params read + activation stream + cache write
  decode:  params read + full KV/state cache read + slice write

Trees are ``launch.specs``' ``meta`` tensors: their bytes are
``numel() * element_size()``, nothing allocated.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeSpec, TrainConfig
from repro_torch.core import tree


def _tree_bytes(tree_) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree.leaves(tree_))


def analytic_bytes(cfg: ModelConfig, shape: ShapeSpec, n_dev: int,
                   tcfg: TrainConfig | None = None) -> float:
    from repro_torch.launch import specs as S
    p_bytes = _tree_bytes(S.params_shape(cfg)) / n_dev
    B, seq = shape.global_batch, shape.seq_len
    act_dtype = 2  # bf16 activations
    d = cfg.d_model
    L = cfg.n_layers
    tokens_local = B * seq / n_dev

    if shape.kind == "train":
        remat = (tcfg is None) or (tcfg.remat != "none")
        moments = 2 * p_bytes * (2 if cfg.moment_dtype == "float32"
                                 else 1)       # m+v, r+w each
        opt_traffic = 2 * moments
        grads = 2 * p_bytes
        params_traffic = 3 * p_bytes
        per_layer_buffers = 12 * (2 if remat else 1)
        acts = tokens_local * d * act_dtype * L * per_layer_buffers
        logits = tokens_local * cfg.vocab_size * act_dtype * 3
        return params_traffic + grads + opt_traffic + acts + logits

    if shape.kind == "prefill":
        acts = tokens_local * d * act_dtype * L * 8
        cache = _cache_bytes(cfg, B, seq) / n_dev
        return p_bytes + acts + cache

    # decode: params + read whole cache + write the new slice
    cache = _cache_bytes(cfg, B, seq) / n_dev
    return p_bytes + cache + (B / n_dev) * d * act_dtype * L * 8


def _cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> float:
    from repro_torch.launch import specs as S
    try:
        return float(_tree_bytes(S.cache_shape(cfg, batch, seq)))
    except ValueError:   # encoder-only: no decode cache
        return 0.0

"""Analytic MODEL_FLOPS (the "useful compute" yardstick of a roofline).

Counterpart of ``repro.launch.modelflops``, term for term:

train:    6 * N_active * tokens        (fwd 2ND + bwd 4ND)
prefill:  2 * N_active * tokens + attention term
decode:   2 * N_active * batch  + attention KV-read term (FLOPs-wise the
          KV dot is 4*B*L*H*dh*S per token)

N_active excludes the token-embedding table (gather, not matmul) but
includes the LM head; MoE experts count at top_k/n_experts utilization plus
always-on shared experts.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeSpec


def _embed_params(cfg: ModelConfig) -> int:
    return cfg.vocab_size * cfg.d_model if cfg.frontend != "audio_frames" \
        else 0


def _expert_params_per_layer(cfg: ModelConfig) -> int:
    moe = cfg.moe
    return moe.n_experts * 3 * cfg.d_model * moe.d_expert


def active_params(cfg: ModelConfig) -> float:
    from repro_torch.launch.specs import param_count
    total = param_count(cfg)
    n = total - _embed_params(cfg)
    if cfg.moe:
        all_exp = cfg.n_layers * _expert_params_per_layer(cfg)
        active_exp = all_exp * cfg.moe.top_k / cfg.moe.n_experts
        n = n - all_exp + active_exp
    return float(n)


def _attn_layers(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers


def attention_flops(cfg: ModelConfig, seq: int, batch: int,
                    kind: str) -> float:
    """Score+AV FLOPs not captured by 6ND."""
    L = _attn_layers(cfg)
    h_dim = cfg.n_heads * cfg.head_dim
    if kind == "train":
        # fwd 2*(2*B*S^2*Hd) causal/2, bwd 2x
        return 3.0 * 2.0 * batch * seq * seq * h_dim * L / 2.0 * 2.0 / 2.0
    if kind == "prefill":
        return 2.0 * batch * seq * seq * h_dim * L / 2.0 * 2.0
    # decode: one query over S cached positions
    return 2.0 * 2.0 * batch * seq * h_dim * L


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    n = active_params(cfg)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * B * S + attention_flops(cfg, S, B, "train")
    if shape.kind == "prefill":
        return 2.0 * n * B * S + attention_flops(cfg, S, B, "prefill")
    return 2.0 * n * B + attention_flops(cfg, S, B, "decode")

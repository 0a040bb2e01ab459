"""Grouped-query attention: full sequence (prefill) and cached one-token
decode.

Counterpart of ``repro.models.attention``: Q, K and V are projected in the
compute dtype and rotated by RoPE; the scores are the compute-dtype product
cast to float32 afterwards (the reference's rounding), scaled by
``1/sqrt(dh)``, causally masked with ``-inf`` and softmaxed in float32,
then cast to V's dtype for the weighted sum and the output projection.
Under ``cfg.shard_hints`` the reference pins the layouts of Q, K, V, the
scores and the output (``sharding.rules.hint``) and writes the decode
cache by a one-hot select. A layout constraint changes no value, and one
PyTorch process has no layout to pin, so the port makes no such calls
(nor in the MLP, the head or the train step's gradients); the one-hot
write equals the direct write, which ``attn_decode`` always does.
``tests/test_torch_rules.py::test_train_step_under_shard_hints_equals_reference``
holds the loss, the gradients and the train step under ``shard_hints``
with an ambient mesh equal to the reference's.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.draws import Stream
from repro_torch.models.common import apply_rope, dense_init, dtype_of


def attn_init(draws: Stream, cfg: ModelConfig, lead: tuple = ()):
    """Attention weights stacked on ``lead``: ``wq``, ``wk``, ``wv``,
    ``wo`` drawn in that order (``wo`` depth-scaled), zero biases under
    ``qkv_bias``."""
    dh, H, K, D = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    pdt = dtype_of(cfg.param_dtype)
    p = {"wq": dense_init(draws, lead, D, H * dh, pdt),
         "wk": dense_init(draws, lead, D, K * dh, pdt),
         "wv": dense_init(draws, lead, D, K * dh, pdt),
         "wo": dense_init(draws, lead, H * dh, D, pdt,
                          scale=1.0 / math.sqrt(H * dh * 2 * cfg.n_layers))}
    if cfg.qkv_bias:
        for name, n in (("bq", H * dh), ("bk", K * dh), ("bv", K * dh)):
            p[name] = torch.zeros(tuple(lead) + (n,), dtype=pdt,
                                  device=draws.device)
    return p


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """x: (B,S,D) -> q (B,S,K,G,dh), k,v (B,S,K,dh)."""
    B, S, _ = x.shape
    dh, H, K = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    G = H // K
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    q = xc @ p["wq"].to(cdt)
    k = xc @ p["wk"].to(cdt)
    v = xc @ p["wv"].to(cdt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, K, dh)
    v = v.reshape(B, S, K, dh)
    if cfg.family != "audio":           # audio stub frontend carries its own pos
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q.reshape(B, S, K, G, dh), k, v


def attn_apply(p, x: torch.Tensor, cfg: ModelConfig,
               positions: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full self-attention. x: (B,S,D); positions: (S,) or (B,S).
    Returns (y (B,S,D), (k, v))."""
    B, S, D = x.shape
    dh, H = cfg.head_dim, cfg.n_heads
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).to(torch.float32)
    scores = scores / math.sqrt(dh)
    if cfg.causal:
        i = torch.arange(S, device=x.device)
        scores = scores.masked_fill(i[:, None] < i[None, :], -math.inf)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v).reshape(B, S, H * dh)
    return o @ p["wo"].to(o.dtype), (k, v)


def attn_decode(p, x: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, pos: int, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B,1,D); caches: (B,Smax,K,dh); pos: the
    position of the new token. Returns (y (B,1,D), k_cache, v_cache).

    The new k/v are written into the caches at ``pos`` in place (the
    reference donates its caches and writes them by
    ``dynamic_update_slice``), and the scores cover positions ``<= pos``.
    """
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
    valid = torch.arange(k_cache.shape[1], device=x.device) <= pos
    y = attend(p, q, k_cache, v_cache, valid, cfg, x.dtype)
    return y, k_cache, v_cache


def attend(p, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           valid: torch.Tensor, cfg: ModelConfig, dtype: torch.dtype
           ) -> torch.Tensor:
    """One query a row, q (B,1,K,G,dh), against k, v (B,T,K,dh) over the
    positions ``valid`` marks (broadcast against the scores (B,K,G,1,T)):
    the output projection y (B,1,D) in ``dtype``."""
    scores = torch.einsum("bqkgd,bskd->bkgqs", q,
                          k.to(q.dtype)).to(torch.float32)
    scores = scores / math.sqrt(cfg.head_dim)
    scores = scores.masked_fill(~valid, -math.inf)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v).reshape(
        q.shape[0], 1, cfg.n_heads * cfg.head_dim)
    return o.to(dtype) @ p["wo"].to(dtype)

"""Multi-head latent attention (MLA), DeepSeek-V2's: a full-sequence
prefill on the decompressed keys and values, and a one-token decode on the
latent cache itself.

Per token, in the compute dtype (``cfg`` an ``MLAConfig``, H heads):

    q            = x Wq  -> (H, nope + rope), split into q_nope, q_pe
    [c, k_pe]    = x Wkv_a   (kv_lora_rank + rope)
    c            = RMSNorm(c) under its own weight ``kv_norm``
    [k_nope, v]  = c Wkv_b -> (H, nope + v_head_dim)

q_pe and the one ``k_pe`` every head shares turn by RoPE at YaRN's
frequencies (``common.yarn_freqs``, on the two halves: the published code
rotates interleaved pairs, which on random weights is a fixed permutation
of Wq's and Wkv_a's RoPE columns). A head's score is
``q_nope . k_nope + q_pe . k_pe`` scaled by ``(nope + rope)^-1/2`` times
YaRN's temperature squared; its output the weighted sum of ``v``, then
``Wo`` over the heads.

The cache holds ``[c, k_pe]`` a token: ``latent_dim`` values. The decode
never decompresses it: ``Wkv_b``'s key half (W_UK) is absorbed into the
query, ``q_lat = q_nope W_UK^T``, so a score is ``[q_lat, q_pe] .
[c, k_pe]``, and its value half (W_UV) is applied after the weighted sum
of the latents. The prefill decompresses: its attention runs in blocks of
queries, each over the keys up to its last query, so that the transient
scores are at most (H, block, S) in float32.

Spans (``repro_torch.telemetry``): ``mla.prefill`` and ``mla.decode``,
host clock only, inside the caller's ``layer.attn``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import telemetry
from repro_torch.configs.base import MLAConfig
from repro_torch.draws import Stream
from repro_torch.models.common import (dense_init, dtype_of, rmsnorm, rotate,
                                       yarn_freqs, yarn_mscale)

PREFILL_BLOCK = 1024                    # queries an attention block holds


def mla_init(draws: Stream, cfg: MLAConfig, lead: tuple = ()):
    """MLA weights stacked on ``lead``: ``wq``, ``wkv_a``, ``wkv_b``,
    ``wo`` drawn in that order (``wo`` depth-scaled), ``kv_norm`` ones."""
    D, H, R = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    pdt = dtype_of(cfg.param_dtype)
    p = {"wq": dense_init(draws, lead, D, H * (dn + dr), pdt),
         "wkv_a": dense_init(draws, lead, D, R + dr, pdt),
         "wkv_b": dense_init(draws, lead, R, H * (dn + dv), pdt),
         "wo": dense_init(draws, lead, H * dv, D, pdt,
                          scale=1.0 / math.sqrt(H * dv * 2 * cfg.n_layers))}
    p["kv_norm"] = torch.ones(tuple(lead) + (R,), dtype=pdt,
                              device=draws.device)
    return p


def scale(cfg: MLAConfig) -> float:
    """The scores' scale: ``(nope + rope)^-1/2`` times YaRN's temperature
    (at ``mscale_all_dim``) squared."""
    m = yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5 * m * m


def _rope(x: torch.Tensor, positions: torch.Tensor, cfg: MLAConfig
          ) -> torch.Tensor:
    """x: (..., S, heads, rope) turned at YaRN's frequencies (the cos/sin
    factor is 1: ``MLAConfig``)."""
    freqs = yarn_freqs(cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_factor,
                       cfg.rope_original_max, cfg.rope_beta_fast,
                       cfg.rope_beta_slow, x.device)
    return rotate(x, positions, freqs)


def _queries(p, xc: torch.Tensor, cfg: MLAConfig, positions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc: (B,S,D) in the compute dtype -> q_nope (B,S,H,nope) and the
    turned q_pe (B,S,H,rope)."""
    B, S, _ = xc.shape
    dn = cfg.qk_nope_head_dim
    q = (xc @ p["wq"].to(xc.dtype)).view(B, S, cfg.n_heads, -1)
    return q[..., :dn], _rope(q[..., dn:], positions, cfg)


def latent(p, xc: torch.Tensor, cfg: MLAConfig, positions: torch.Tensor
           ) -> torch.Tensor:
    """What the cache holds of xc (B,S,D): ``[RMSNorm(c), turned k_pe]``
    (B,S,latent_dim) in the compute dtype."""
    R = cfg.kv_lora_rank
    ckv = xc @ p["wkv_a"].to(xc.dtype)
    c = rmsnorm(ckv[..., :R], p["kv_norm"], cfg.norm_eps)
    k_pe = _rope(ckv[..., None, R:], positions, cfg)[..., 0, :]
    return torch.cat([c, k_pe], dim=-1)


def mla_apply(p, x: torch.Tensor, cfg: MLAConfig,
              positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal self-attention over x (B,S,D), decompressed. Returns (y
    (B,S,D), the latent cache (B,S,latent_dim))."""
    with telemetry.inner("mla.prefill"):
        B, S, _ = x.shape
        H, R = cfg.n_heads, cfg.kv_lora_rank
        dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
        cdt = dtype_of(cfg.compute_dtype)
        xc = x.to(cdt)
        q_nope, q_pe = _queries(p, xc, cfg, positions)
        lat = latent(p, xc, cfg, positions)
        kv = (lat[..., :R] @ p["wkv_b"].to(cdt)).view(B, S, H, dn + dv)
        k_pe = lat[..., None, R:].expand(B, S, H, cfg.qk_rope_head_dim)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([kv[..., :dn], k_pe], dim=-1)
        v = kv[..., dn:]
        sc = scale(cfg)
        i = torch.arange(S, device=x.device)
        o = torch.empty(B, S, H, dv, dtype=cdt, device=x.device)
        for a in range(0, S, PREFILL_BLOCK):
            b = min(a + PREFILL_BLOCK, S)
            s = torch.einsum("bqhd,bshd->bhqs", q[:, a:b],
                             k[:, :b]).to(torch.float32) * sc
            s = s.masked_fill(i[a:b, None] < i[None, :b], -math.inf)
            w = torch.softmax(s, dim=-1).to(cdt)
            o[:, a:b] = torch.einsum("bhqs,bshd->bqhd", w, v[:, :b])
        return o.reshape(B, S, H * dv) @ p["wo"].to(cdt), lat


def mla_decode(p, x: torch.Tensor, lat: torch.Tensor, valid: torch.Tensor,
               cfg: MLAConfig, positions: torch.Tensor) -> torch.Tensor:
    """One token a row, absorbed: x (B,1,D) at ``positions`` (B,1)
    against the latent cache lat (B,T,latent_dim), which already holds
    the token's own latent, over the positions ``valid`` (B,T) marks.
    Returns y (B,1,D)."""
    with telemetry.inner("mla.decode"):
        B = x.shape[0]
        H, R = cfg.n_heads, cfg.kv_lora_rank
        dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
        cdt = dtype_of(cfg.compute_dtype)
        q_nope, q_pe = _queries(p, x.to(cdt), cfg, positions)
        wkv_b = p["wkv_b"].to(cdt).view(R, H, dn + dv)
        w_uk = wkv_b[..., :dn].permute(1, 2, 0)              # (H, nope, R)
        w_uv = wkv_b[..., dn:].transpose(0, 1)               # (H, R, v)
        q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1), w_uk)   # (H, B, R)
        q = torch.cat([q_lat.transpose(0, 1), q_pe[:, 0]], dim=-1)
        lat = lat.to(cdt)
        s = torch.bmm(q, lat.transpose(1, 2)).to(torch.float32) * scale(cfg)
        s = s.masked_fill(~valid[:, None, :], -math.inf)     # (B, H, T)
        w = torch.softmax(s, dim=-1).to(cdt)
        o_lat = torch.bmm(w, lat[..., :R])                   # (B, H, R)
        o = torch.bmm(o_lat.transpose(0, 1), w_uv)           # (H, B, v)
        o = o.transpose(0, 1).reshape(B, 1, H * dv)
        return o @ p["wo"].to(cdt)

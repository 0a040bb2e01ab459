"""Plain forward pass of a DeepSeek-V2 decoder, in float32 with TF32 off.

Written from the published modelling code's equations; ``c`` is the
configuration file's dict, under the published ``config.json`` keys.
Per layer: RMSNorm, then multi-head latent attention (MLA), decompressed
at every position:

    q = h Wq -> (S, H, nope + rope);    [c, k_pe] = h Wkv_a;
    c = RMSNorm(c) (weight ``kv_norm``);
    [k_nope, v] = c Wkv_b -> (S, H, nope + v)

q's RoPE part and the one ``k_pe`` all heads share turn by RoPE at YaRN's
frequencies (``rope_scaling``), on the two halves of the RoPE part (the
published code turns interleaved pairs: on random weights a fixed
permutation of Wq's and Wkv_a's RoPE columns). Scores ``q . k`` times
``(nope + rope)^-1/2 mscale^2`` (``mscale = 0.1 mscale_all_dim ln(factor)
+ 1``), causal softmax, the weighted sum of ``v``, ``Wo``. Then RMSNorm
and the FFN: a dense SwiGLU in the first ``first_k_dense_replace``
layers, else the MoE: a float32 router, softmax gates, the
``num_experts_per_tok`` largest (ties to the lower expert id), renormalised
only under ``norm_topk_prob``, times ``routed_scaling_factor``, each chosen
expert's SwiGLU weighted by its gate, plus the shared experts' SwiGLU;
nothing dropped. A final RMSNorm and the head give the logits.

The weights are the benchmark's (``hrmbench/mla.py``): ``dense_blocks``
for the dense layers, ``blocks`` for the MoE layers, stacked. No cache,
no kernels, nothing of the port. ``prec`` is ``model.Precision``: float32,
the float8 e4m3 control, or float64.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from hrmbench.reference.model import (FLOAT32, Precision, _swiglu,
                                      exact_float32, rmsnorm)


def yarn_freqs(c: dict, dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
    """(rope / 2,) YaRN's frequencies: ``m`` of theta's own frequency and
    ``1 - m`` of it divided by ``factor``, ``m = 1 - ramp(low, high)``
    over the pairs, ``low = floor(dim_of(beta_fast))``, ``high =
    ceil(dim_of(beta_slow))``, ``dim_of(r) = rope ln(original / (2 pi
    r)) / (2 ln theta)``."""
    rs, dim, theta = c["rope_scaling"], c["qk_rope_head_dim"], \
        float(c["rope_theta"])

    def dim_of(r):
        return dim * math.log(rs["original_max_position_embeddings"]
                              / (2 * math.pi * r)) / (2 * math.log(theta))

    low = max(math.floor(dim_of(rs["beta_fast"])), 0)
    high = min(math.ceil(dim_of(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    base = theta ** (torch.arange(0, dim, 2, dtype=dtype, device=device)
                     / dim)
    ramp = ((torch.arange(dim // 2, dtype=dtype, device=device) - low)
            / (high - low)).clamp(0, 1)
    m = 1 - ramp
    return 1 / (rs["factor"] * base) * (1 - m) + 1 / base * m


def mscale(c: dict, key: str = "mscale_all_dim") -> float:
    rs = c["rope_scaling"]
    return 0.1 * rs[key] * math.log(rs["factor"]) + 1.0 \
        if rs["factor"] > 1 else 1.0


def softmax_scale(c: dict) -> float:
    return (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5 \
        * mscale(c) ** 2


def rope(x: torch.Tensor, pos: torch.Tensor, freqs: torch.Tensor
         ) -> torch.Tensor:
    """x: (S, heads, rope) turned at ``freqs``, on its two halves."""
    ang = (pos.to(x.dtype)[:, None] * freqs.to(x.dtype))[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(aw: Dict, l: int, h: torch.Tensor, c: dict,
               prec: Precision) -> torch.Tensor:
    S = h.shape[0]
    H, R = c["num_attention_heads"], c["kv_lora_rank"]
    dn, dr, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], \
        c["v_head_dim"]
    pos = torch.arange(S, device=h.device)
    freqs = yarn_freqs(c, h.dtype, h.device)
    amp = mscale(c, "mscale") / mscale(c)
    q = prec.mm(h, aw["wq"][l]).view(S, H, dn + dr)
    ckv = prec.mm(h, aw["wkv_a"][l])
    lat = rmsnorm(ckv[:, :R], aw["kv_norm"][l], c["rms_norm_eps"])
    k_pe = rope(ckv[:, None, R:], pos, freqs) * amp           # (S, 1, rope)
    kv = prec.mm(lat, aw["wkv_b"][l]).view(S, H, dn + dv)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, freqs) * amp], -1)
    k = torch.cat([kv[..., :dn], k_pe.expand(S, H, dr)], -1)
    v = kv[..., dn:]
    out = torch.empty(S, H, dv, device=h.device, dtype=h.dtype)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).triu(1)
    sc = softmax_scale(c)
    for i in range(H):                          # one head at a time: S x S
        s = (q[:, i] @ k[:, i].T) * sc
        p = torch.softmax(s.masked_fill(causal, -math.inf), dim=-1)
        out[:, i] = p @ v[:, i]
    return prec.mm(out.reshape(S, H * dv), aw["wo"][l])


def _moe(mw: Dict, l: int, x: torch.Tensor, c: dict,
         prec: Precision) -> torch.Tensor:
    E, top_k = c["n_routed_experts"], c["num_experts_per_tok"]
    gates = torch.softmax(prec.mm(x, mw["router"][l]), dim=-1)
    w, e = torch.sort(gates, dim=-1, descending=True, stable=True)
    w, e = w[:, :top_k], e[:, :top_k]
    if c["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    w = w * c["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for ex in range(E):
        rows, slot = (e == ex).nonzero(as_tuple=True)
        if rows.numel():
            ye = _swiglu(x[rows], mw["wi"][l, ex], mw["wg"][l, ex],
                         mw["wo"][l, ex], prec)
            y.index_add_(0, rows, ye * w[rows, slot, None])
    sh = mw["shared"]
    return y + _swiglu(x, sh["wi"][l], sh["wg"][l], sh["wo"][l], prec)


def logits(w: Dict, c: dict, tokens: torch.Tensor, *,
           last: Optional[int] = None,
           prec: Precision = FLOAT32) -> torch.Tensor:
    """Logits of one sequence ``tokens`` (S,) in ``prec``'s dtype: every
    position, or the ``last`` ones."""
    eps = c["rms_norm_eps"]
    n_dense = c["first_k_dense_replace"]
    with exact_float32():
        x = prec.rows(w["embed"], tokens)
        for layer in range(c["num_hidden_layers"]):
            dense = layer < n_dense
            b = w["dense_blocks"] if dense else w["blocks"]
            l = layer if dense else layer - n_dense
            x = x + _attention(b["attn"], l, rmsnorm(x, b["norm1"][l], eps),
                               c, prec)
            hn = rmsnorm(x, b["norm2"][l], eps)
            if dense:
                m = b["mlp"]
                x = x + _swiglu(hn, m["wi"][l], m["wg"][l], m["wo"][l], prec)
            else:
                x = x + _moe(b["moe"], l, hn, c, prec)
        if last is not None:
            x = x[-last:]
        return prec.mm(rmsnorm(x, w["final_norm"], eps), w["head"])

"""Plain forward pass of a dense or MoE decoder, in float32 with TF32 off.

Per layer: RMSNorm, Q/K/V projections, RoPE on the two halves of each head
(theta from the configuration), causal softmax attention with grouped
KV heads (query head ``h`` reads KV head ``h // (H / K)``), the output
projection, RMSNorm, then the MoE: a float32 router, softmax gates, the
``top_k`` largest (ties to the lower expert id), renormalised to sum to 1,
each chosen expert's SwiGLU ``(silu(x Wi) * (x Wg)) Wo`` weighted by its
gate, plus the shared experts' SwiGLU; nothing is dropped. A final RMSNorm
and the head give the logits.

``Precision(fp8=True)`` is the control: every product with a weight takes
both operands rounded to float8 e4m3 (activations scaled per row, weights
per output column), the rest as above. ``FLOAT64`` computes in float64, to
find where a struck model's float32 result is itself ill-conditioned.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """Matrix products in true float32 (TF32 off) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale per slice along ``dim``."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Precision:
    """How the reference multiplies by a weight, and in which dtype."""

    def __init__(self, fp8: bool = False, dtype: torch.dtype = torch.float32):
        self.fp8 = fp8
        self.dtype = dtype

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        a, w = a.to(self.dtype), w.to(self.dtype)
        if self.fp8:
            a, w = fp8_round(a, -1), fp8_round(w, -2)
        return a @ w

    def rows(self, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        x = table[idx].to(self.dtype)
        return fp8_round(x, -1) if self.fp8 else x


FLOAT32 = Precision()
FLOAT64 = Precision(dtype=torch.float64)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * w.to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, heads, dh); rotates the two halves of each head."""
    dh = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=x.dtype,
                                          device=x.device) / dh))
    ang = (pos.to(x.dtype)[:, None] * freqs.to(x.dtype))[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(lw: Dict, l: int, h: torch.Tensor, c: dict,
               prec: Precision) -> torch.Tensor:
    S = h.shape[0]
    H, K = c["n_heads"], c["n_kv_heads"]
    dh = c["d_model"] // H
    theta = c["rope_theta"]
    pos = torch.arange(S, device=h.device)
    q = rope(prec.mm(h, lw["wq"][l]).view(S, H, dh), pos, theta)
    k = rope(prec.mm(h, lw["wk"][l]).view(S, K, dh), pos, theta)
    v = prec.mm(h, lw["wv"][l]).view(S, K, dh)
    k = k.repeat_interleave(H // K, dim=1)
    v = v.repeat_interleave(H // K, dim=1)
    out = torch.empty(S, H, dh, device=h.device, dtype=h.dtype)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).triu(1)
    for i in range(H):                          # one head at a time: S x S
        s = (q[:, i] @ k[:, i].T) / math.sqrt(dh)
        p = torch.softmax(s.masked_fill(causal, -math.inf), dim=-1)
        out[:, i] = p @ v[:, i]
    return prec.mm(out.reshape(S, H * dh), lw["wo"][l])


def _swiglu(x, wi, wg, wo, prec: Precision) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(x, wi)) * prec.mm(x, wg), wo)


def _moe(mw: Dict, l: int, x: torch.Tensor, c: dict,
         prec: Precision) -> torch.Tensor:
    moe = c["moe"]
    E, top_k = moe["n_experts"], moe["top_k"]
    gates = torch.softmax(prec.mm(x, mw["router"][l]), dim=-1)
    w, e = torch.sort(gates, dim=-1, descending=True, stable=True)
    w, e = w[:, :top_k], e[:, :top_k]
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    y = torch.zeros_like(x)
    for ex in range(E):
        rows, slot = (e == ex).nonzero(as_tuple=True)
        if rows.numel():
            ye = _swiglu(x[rows], mw["wi"][l, ex], mw["wg"][l, ex],
                         mw["wo"][l, ex], prec)
            y.index_add_(0, rows, ye * w[rows, slot, None])
    if "shared" in mw:
        sh = mw["shared"]
        y = y + _swiglu(x, sh["wi"][l], sh["wg"][l], sh["wo"][l], prec)
    return y


def logits(w: Dict, c: dict, tokens: torch.Tensor, *,
           last: Optional[int] = None,
           prec: Precision = FLOAT32) -> torch.Tensor:
    """Logits of one sequence ``tokens`` (S,) in ``prec``'s dtype (float32
    unless asked): every position, or the ``last`` ones."""
    eps = c["norm_eps"]
    b = w["blocks"]
    with exact_float32():
        x = prec.rows(w["embed"], tokens)
        for l in range(c["n_layers"]):
            x = x + _attention(b["attn"], l, rmsnorm(x, b["norm1"][l], eps),
                               c, prec)
            hn = rmsnorm(x, b["norm2"][l], eps)
            if "moe" in b:
                x = x + _moe(b["moe"], l, hn, c, prec)
            else:
                m = b["mlp"]
                x = x + _swiglu(hn, m["wi"][l], m["wg"][l], m["wo"][l], prec)
        if last is not None:
            x = x[-last:]
        return prec.mm(rmsnorm(x, w["final_norm"], eps), w["head"])

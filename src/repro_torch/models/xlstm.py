"""xLSTM blocks: mLSTM (matrix memory, chunked) and sLSTM (scalar,
recurrent).

Counterpart of ``repro.models.xlstm``. The mLSTM's matrix-memory
recurrence

    C_t = f_t C_{t-1} + i_t k_t v_t^T,   n_t = f_t n_{t-1} + i_t k_t,
    h_t = (C_t^T q_t) / max(|n_t^T q_t|, 1)

runs on the shared chunked GLA core: the exponential input gate is folded
into k (its log capped at +8, the reference's stand-in for the paper's
running max-state) and the normaliser n rides as an extra column of v.

The sLSTM keeps the paper's stabilised scalar recurrence (exponential
gating with the max-state m) with block-diagonal per-head recurrent
weights ``r_rec`` (H, dh, 4 dh); it is sequential, a Python loop over
time where the reference scans.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.draws import Stream
from repro_torch.models.common import dense_init, dtype_of, rmsnorm
from repro_torch.models.gla import chunked_gla, gla_step
from repro_torch.models.mamba2 import _conv    # the shared causal conv

_LOG_I_CAP = 8.0


def _dims(cfg: ModelConfig):
    d_inner = cfg.xlstm.expand * cfg.d_model
    H = cfg.n_heads
    return d_inner, H, d_inner // H


def _full(lead: tuple, n: int, value: float, device) -> torch.Tensor:
    return torch.full(tuple(lead) + (n,), value, dtype=torch.float32,
                      device=device)


# ------------------------------------------------------------------ mLSTM
def mlstm_init(draws: Stream, cfg: ModelConfig, lead: tuple = ()):
    """One mLSTM block's weights, stacked on ``lead``: ``up_proj``,
    ``conv_w`` (normal x 0.1), ``wq``, ``wk``, ``wv``, ``w_if`` and
    ``down_proj`` drawn in that order; the biases and the norm are
    computed."""
    D = cfg.d_model
    d_inner, H, _ = _dims(cfg)
    pdt = dtype_of(cfg.param_dtype)
    dev = draws.device
    p = {"up_proj": dense_init(draws, lead, D, 2 * d_inner, pdt),
         "conv_w": draws.normal(tuple(lead) + (4, d_inner), 0.1, pdt)}
    for name in ("wq", "wk", "wv"):
        p[name] = dense_init(draws, lead, d_inner, d_inner, pdt)
    p["w_if"] = dense_init(draws, lead, d_inner, 2 * H, pdt, scale=0.01)
    p["down_proj"] = dense_init(draws, lead, d_inner, D, pdt)
    p.update(conv_b=torch.zeros(tuple(lead) + (d_inner,), dtype=pdt,
                                device=dev),
             b_i=_full(lead, H, -2.0, dev), b_f=_full(lead, H, 3.0, dev),
             norm_w=torch.ones(tuple(lead) + (d_inner,), dtype=pdt,
                               device=dev))
    return p


def _mlstm_qkvif(p, x: torch.Tensor, cfg: ModelConfig, conv_state=None):
    """x: (B,S,D) -> q,k,v (B,S,H,dh), log_i/log_f (B,S,H), z,
    conv_state."""
    d_inner, H, dh = _dims(cfg)
    B, S, _ = x.shape
    cdt = dtype_of(cfg.compute_dtype)
    up = x.to(cdt) @ p["up_proj"].to(cdt)
    x_in, z = torch.chunk(up, 2, dim=-1)
    x_c, conv_state = _conv(x_in, p["conv_w"], p["conv_b"], conv_state)
    q = (x_c @ p["wq"].to(cdt)).reshape(B, S, H, dh)
    k = (x_c @ p["wk"].to(cdt)).reshape(B, S, H, dh) / torch.sqrt(
        torch.tensor(dh, dtype=cdt, device=x.device))
    v = (x_in @ p["wv"].to(cdt)).reshape(B, S, H, dh)
    gates = (x_in @ p["w_if"].to(cdt)).to(torch.float32)
    log_i = torch.clamp(gates[..., :H] + p["b_i"], max=_LOG_I_CAP)
    log_f = F.logsigmoid(gates[..., H:] + p["b_f"])
    return q, k, v, log_i, log_f, z, conv_state


def _gated_kv(k: torch.Tensor, v: torch.Tensor, log_i: torch.Tensor):
    """k with the input gate folded in, v with the normaliser's column of
    ones."""
    k = k * torch.exp(log_i)[..., None].to(k.dtype)
    ones = torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
    return k, torch.cat([v, ones], dim=-1)


def _mlstm_output(p, y_aug: torch.Tensor, z: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    d_inner = _dims(cfg)[0]
    num, den = y_aug[..., :-1], y_aug[..., -1:]
    h = num / torch.clamp(torch.abs(den), min=1.0)
    h = h.reshape(y_aug.shape[:-2] + (d_inner,))
    cdt = dtype_of(cfg.compute_dtype)
    h = rmsnorm(h.to(cdt) * F.silu(z), p["norm_w"], cfg.norm_eps)
    return h @ p["down_proj"].to(cdt)


def mlstm_apply(p, x: torch.Tensor, cfg: ModelConfig, initial_state=None):
    """x: (B,S,D) -> y (B,S,D), (conv_state, C_state)."""
    conv_in, c_in = (None, None) if initial_state is None else initial_state
    q, k, v, log_i, log_f, z, conv_state = _mlstm_qkvif(p, x, cfg, conv_in)
    k, v_aug = _gated_kv(k, v, log_i)
    y_aug, c_state = chunked_gla(q, k, v_aug, log_f, cfg.xlstm.chunk,
                                 initial_state=c_in)
    return _mlstm_output(p, y_aug, z, cfg), (conv_state, c_state)


def mlstm_decode(p, x: torch.Tensor, state, cfg: ModelConfig):
    """x: (B,1,D); state = (conv_state, C (B,H,dh,dh+1))."""
    conv_state, c_state = state
    q, k, v, log_i, log_f, z, conv_state = _mlstm_qkvif(p, x, cfg,
                                                        conv_state)
    k, v_aug = _gated_kv(k, v, log_i)
    y_aug, c_state = gla_step(q[:, 0], k[:, 0], v_aug[:, 0], log_f[:, 0],
                              c_state)
    return _mlstm_output(p, y_aug[:, None], z, cfg), (conv_state, c_state)


def mlstm_state_init(cfg: ModelConfig, batch: int, device):
    """(conv_state (B,3,d_inner) in the compute dtype, C (B,H,dh,dh+1)
    float32), zero-filled."""
    d_inner, H, dh = _dims(cfg)
    return (torch.zeros((batch, 3, d_inner),
                        dtype=dtype_of(cfg.compute_dtype), device=device),
            torch.zeros((batch, H, dh, dh + 1), dtype=torch.float32,
                        device=device))


# ------------------------------------------------------------------ sLSTM
def slstm_init(draws: Stream, cfg: ModelConfig, lead: tuple = ()):
    """One sLSTM block's weights, stacked on ``lead``: ``w_in``, ``r_rec``
    (normal / sqrt(dh)) and ``out_proj`` drawn in that order; the gate
    biases (0 | -2 | 3 | 0 over z, i, f, o) and the norm computed."""
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    pdt = dtype_of(cfg.param_dtype)
    dev = draws.device
    w_in = dense_init(draws, lead, D, 4 * D, pdt)
    r_rec = draws.normal(tuple(lead) + (H, dh, 4 * dh), 1.0 / math.sqrt(dh),
                         pdt)
    out_proj = dense_init(draws, lead, D, D, pdt)
    b = torch.cat([torch.zeros(D), torch.full((D,), -2.0),
                   torch.full((D,), 3.0), torch.zeros(D)])
    return {"w_in": w_in, "r_rec": r_rec,
            "b": b.expand(tuple(lead) + b.shape).contiguous().to(dev),
            "norm_w": torch.ones(tuple(lead) + (D,), dtype=pdt, device=dev),
            "out_proj": out_proj}


def _slstm_step(p, xt: torch.Tensor, state, cfg: ModelConfig):
    """xt: (B,4D) pre-projected input; state = (c,n,h,m) each (B,D)."""
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    c, n, h, m = state
    B = xt.shape[0]
    # recurrent contribution, block-diagonal per head
    hb = h.reshape(B, H, dh).to(p["r_rec"].dtype)
    rec = torch.einsum("bhd,hde->bhe", hb, p["r_rec"]).reshape(B, 4 * D)
    pre = (xt + rec.to(torch.float32)).to(torch.float32) + p["b"]
    zt = torch.tanh(pre[..., 0 * D:1 * D])
    it = pre[..., 1 * D:2 * D]
    ft = F.logsigmoid(pre[..., 2 * D:3 * D])
    ot = torch.sigmoid(pre[..., 3 * D:4 * D])
    m_new = torch.maximum(ft + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + m - m_new)
    c = f_p * c + i_p * zt
    n = f_p * n + i_p
    h = ot * c / torch.clamp(n, min=1.0)
    return (c, n, h, m_new)


def slstm_apply(p, x: torch.Tensor, cfg: ModelConfig, initial_state=None):
    """x: (B,S,D) -> y (B,S,D), final state (c,n,h,m)."""
    B, S, _ = x.shape
    cdt = dtype_of(cfg.compute_dtype)
    xt = (x.to(cdt) @ p["w_in"].to(cdt)).to(torch.float32)
    state = initial_state or slstm_state_init(cfg, B, x.device)
    hs = []
    for t in range(S):
        state = _slstm_step(p, xt[:, t], state, cfg)
        hs.append(state[2])                              # emit h
    y = rmsnorm(torch.stack(hs, dim=1).to(cdt), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"].to(cdt), state


def slstm_decode(p, x: torch.Tensor, state, cfg: ModelConfig):
    cdt = dtype_of(cfg.compute_dtype)
    xt = (x[:, 0].to(cdt) @ p["w_in"].to(cdt)).to(torch.float32)
    state = _slstm_step(p, xt, state, cfg)
    y = rmsnorm(state[2][:, None].to(cdt), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"].to(cdt), state


def slstm_state_init(cfg: ModelConfig, batch: int, device):
    """(c, n, h, m) each (B, D) float32; m starts low (-10)."""
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                    device=device)
    return (z, z.clone(), z.clone(), z - 10.0)

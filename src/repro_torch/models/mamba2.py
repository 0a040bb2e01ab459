"""Mamba2 (SSD) mixer: the chunked scan for a whole sequence and the
recurrent one-token step.

Counterpart of ``repro.models.mamba2``: in_proj -> [z | x | B | C | dt],
a causal depthwise conv over [x|B|C], softplus(dt) + A gating, the SSD
scan through ``gla.chunked_gla`` (q = C, k = B, v = dt * x, log_f = dt *
A), a gated RMSNorm and out_proj. d_inner = expand * d_model in heads of
``head_dim``; B and C are shared by all heads (one group).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.draws import Stream
from repro_torch.models.common import dense_init, dtype_of, rmsnorm
from repro_torch.models.gla import chunked_gla, gla_step


def _dims(cfg: ModelConfig):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    n_heads = d_inner // ssm.head_dim
    conv_dim = d_inner + 2 * ssm.d_state
    return d_inner, n_heads, conv_dim


def mamba_init(draws: Stream, cfg: ModelConfig, lead: tuple = ()):
    """One Mamba2 mixer's weights, stacked on ``lead``: ``in_proj``,
    ``conv_w`` (normal x 0.1) and ``out_proj`` drawn in that order; the
    rest is computed."""
    ssm = cfg.ssm
    d_inner, H, conv_dim = _dims(cfg)
    D = cfg.d_model
    pdt = dtype_of(cfg.param_dtype)
    dev = draws.device
    f32 = torch.float32
    d_in_proj = 2 * d_inner + 2 * ssm.d_state + H
    # computed on the CPU, so the same on every device
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=f32))
    in_proj = dense_init(draws, lead, D, d_in_proj, pdt)
    conv_w = draws.normal(tuple(lead) + (ssm.d_conv, conv_dim), 0.1, pdt)
    out_proj = dense_init(draws, lead, d_inner, D, pdt)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(tuple(lead) + (conv_dim,), dtype=pdt,
                              device=dev),
        "A_log": a_log.expand(tuple(lead) + (H,)).contiguous().to(dev),
        "dt_bias": torch.full(tuple(lead) + (H,), -2.0, dtype=f32,
                              device=dev),      # softplus(-2) ~ 0.13
        "D_skip": torch.ones(tuple(lead) + (H,), dtype=f32, device=dev),
        "norm_w": torch.ones(tuple(lead) + (d_inner,), dtype=pdt,
                             device=dev),
        "out_proj": out_proj,
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    d_inner, H, _ = _dims(cfg)
    N = cfg.ssm.d_state
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_inner + 2 * N]
    dt = zxbcdt[..., -H:]
    return z, xbc, dt


def _conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state=None):
    """Causal depthwise conv. xbc: (B,S,Cc); w: (W,Cc); state: (B,W-1,Cc).
    Returns (silu(conv + b), the last W-1 inputs as the new state)."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], W - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                    # (B, S+W-1, Cc)
    S = xbc.shape[1]
    wc = w.to(xbc.dtype)
    # the reference's Python sum: 0 + term_0 + term_1 + ...
    out = 0
    for i in range(W):
        out = out + xp[:, i:i + S] * wc[i][None, None, :]
    new_state = xp[:, -(W - 1):] if W > 1 else pad
    return F.silu(out + b.to(xbc.dtype)), new_state


def _ssd_inputs(p, zxbcdt: torch.Tensor, cfg: ModelConfig, conv_state):
    """The SSD scan's operands from in_proj's output (B,S,·): z, xs
    (B,S,H,P), q/k (B,S,H,N) broadcast over heads, v, log_f (B,S,H) and the
    conv's new state."""
    ssm = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    N, P = ssm.d_state, ssm.head_dim
    B_, S = zxbcdt.shape[:2]
    z, xbc, dt_raw = _split_proj(zxbcdt, cfg)
    xbc, conv_state = _conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs = xbc[..., :d_inner].reshape(B_, S, H, P)
    Bmat = xbc[..., d_inner:d_inner + N]                 # (B,S,N) shared
    Cmat = xbc[..., d_inner + N:]
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])   # (B,S,H)
    A = -torch.exp(p["A_log"])                           # (H,) negative
    log_f = dt * A[None, None, :]                        # (B,S,H) <= 0
    q = Cmat[:, :, None, :].expand(B_, S, H, N)
    k = Bmat[:, :, None, :].expand(B_, S, H, N)
    v = xs * dt[..., None].to(xs.dtype)                  # dt folded into v
    return z, xs, q, k, v, log_f, conv_state


def _ssd_output(p, y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    d_inner = _dims(cfg)[0]
    y = y + xs * p["D_skip"][None, None, :, None].to(xs.dtype)
    y = y.reshape(*y.shape[:2], d_inner)
    y = rmsnorm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"].to(dtype_of(cfg.compute_dtype))


def mamba_apply(p, x: torch.Tensor, cfg: ModelConfig, initial_state=None):
    """x: (B,S,D) -> (y (B,S,D), (conv_state, ssm_state))."""
    cdt = dtype_of(cfg.compute_dtype)
    zxbcdt = x.to(cdt) @ p["in_proj"].to(cdt)
    conv_in, ssm_in = (None, None) if initial_state is None \
        else initial_state
    z, xs, q, k, v, log_f, conv_state = _ssd_inputs(p, zxbcdt, cfg,
                                                    conv_in)
    y, ssm_state = chunked_gla(q, k, v, log_f, cfg.ssm.chunk,
                               initial_state=ssm_in)
    return _ssd_output(p, y, xs, z, cfg), (conv_state, ssm_state)


def mamba_decode(p, x: torch.Tensor, state, cfg: ModelConfig):
    """One-token step. x: (B,1,D); state = (conv_state (B,W-1,Cc), ssm
    (B,H,N,P)) -> (y (B,1,D), new state)."""
    cdt = dtype_of(cfg.compute_dtype)
    conv_state, ssm_state = state
    zxbcdt = x.to(cdt) @ p["in_proj"].to(cdt)
    z, xs, q, k, v, log_f, conv_state = _ssd_inputs(p, zxbcdt, cfg,
                                                    conv_state)
    y, ssm_state = gla_step(q[:, 0], k[:, 0], v[:, 0], log_f[:, 0],
                            ssm_state)
    return _ssd_output(p, y[:, None], xs, z, cfg), (conv_state, ssm_state)


def mamba_state_init(cfg: ModelConfig, batch: int, device):
    """(conv_state (B,W-1,Cc) in the compute dtype, ssm_state (B,H,N,P)
    float32), zero-filled."""
    ssm = cfg.ssm
    _, H, conv_dim = _dims(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    return (torch.zeros((batch, ssm.d_conv - 1, conv_dim), dtype=cdt,
                        device=device),
            torch.zeros((batch, H, ssm.d_state, ssm.head_dim),
                        dtype=torch.float32, device=device))

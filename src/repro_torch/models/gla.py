"""Chunked gated linear attention: the sub-quadratic sequence mixer that
Mamba2 and the mLSTM share.

Counterpart of ``repro.models.gla``. Per head, the causal linear-attention
recurrence

    h_t = exp(log_f_t) * h_{t-1} + k_t (x) v_t          (state: (N, P))
    y_t = q_t . h_t

in O(S.N.P) by the chunkwise decomposition: a quadratic part inside each
chunk and a recurrent carry between chunks. The reference's ``lax.scan``
over chunks is a Python loop over them. All decay algebra is in float32,
and ``log_f <= 0`` (a true decay) keeps every exponent non-positive. A
sequence that is not a whole number of chunks is padded with
decay-neutral steps (``k = v = 0`` adds nothing to the state, ``log_f =
0`` carries it unchanged), and the padded rows are cut from ``y``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def chunked_gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_f: torch.Tensor, chunk: int, initial_state=None):
    """q,k: (B,S,H,N) v: (B,S,H,P) log_f: (B,S,H) -> y (B,S,H,P) in v's
    dtype, h (B,H,N,P) float32."""
    B, S, H, N = q.shape
    P = v.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        pad = chunk - S % chunk

        def padf(a):
            return F.pad(a, [0, 0] * (a.ndim - 2) + [0, pad])
        q, k, v, log_f = padf(q), padf(k), padf(v), padf(log_f)
    nc, c = q.shape[1] // chunk, chunk

    f32 = torch.float32
    qf = q.to(f32).reshape(B, nc, c, H, N)
    kf = k.to(f32).reshape(B, nc, c, H, N)
    vf = v.to(f32).reshape(B, nc, c, H, P)
    lf = log_f.to(f32).reshape(B, nc, c, H)

    # b_t: within-chunk cumulative log-decay (inclusive)
    b = torch.cumsum(lf, dim=2)                          # (B,nc,c,H)
    b_total = b[:, :, -1]                                # (B,nc,H)

    # intra-chunk: scores_ij = (q_i . k_j) * exp(b_i - b_j), j <= i; the
    # inner where keeps exp off the masked (positive) exponents, whose inf
    # times the outer 0 would be NaN
    att = torch.einsum("bnihd,bnjhd->bnhij", qf, kf)     # (B,nc,H,c,c)
    bi = b.permute(0, 1, 3, 2)                           # (B,nc,H,c)
    dmat = bi[..., :, None] - bi[..., None, :]           # (B,nc,H,c,c)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    att = att * torch.where(mask, torch.exp(torch.where(mask, dmat, 0.0)),
                            0.0)
    y_intra = torch.einsum("bnhij,bnjhp->bnihp", att, vf)   # (B,nc,c,H,P)

    # inter-chunk carried state: chunk n adds sum_j exp(b_total - b_j) k_j v_j
    kdec = kf * torch.exp(b_total[:, :, None] - b)[..., None]
    state_add = torch.einsum("bnchd,bnchp->bnhdp", kdec, vf)  # (B,nc,H,N,P)

    h = torch.zeros((B, H, N, P), dtype=f32, device=q.device) \
        if initial_state is None else initial_state.to(f32)
    h_enter = []
    for n in range(nc):
        h_enter.append(h)                                # state entering n
        h = h * torch.exp(b_total[:, n])[..., None, None] + state_add[:, n]
    h_enter = torch.stack(h_enter, dim=1)                # (B,nc,H,N,P)

    # y_inter_i = exp(b_i) * q_i . h_enter
    qdec = qf * torch.exp(b)[..., None]
    y_inter = torch.einsum("bnchd,bnhdp->bnchp", qdec, h_enter)

    y = (y_intra + y_inter).reshape(B, nc * c, H, P)[:, :S]
    return y.to(v.dtype), h


def gla_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_f: torch.Tensor, state: torch.Tensor):
    """Single-token recurrent step. q,k: (B,H,N) v: (B,H,P) log_f: (B,H)
    state: (B,H,N,P) -> y (B,H,P) in v's dtype, new state float32."""
    f32 = torch.float32
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    state = state.to(f32) * torch.exp(log_f.to(f32))[..., None, None]
    state = state + kf[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhd,bhdp->bhp", qf, state)
    return y.to(v.dtype), state


def gla_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_f: torch.Tensor):
    """Plain recurrent oracle (a loop over time of ``gla_step``) for
    tests: (y (B,S,H,P), final state)."""
    B, S, H, N = q.shape
    h = torch.zeros((B, H, N, v.shape[-1]), dtype=torch.float32,
                    device=q.device)
    ys = []
    for t in range(S):
        y, h = gla_step(q[:, t], k[:, t], v[:, t], log_f[:, t], h)
        ys.append(y)
    return torch.stack(ys, dim=1), h

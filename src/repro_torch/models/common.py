"""Shared building blocks of the port's models, over plain dict state.

Counterpart of ``repro.models.common``: the same math, in PyTorch. RMSNorm
and RoPE compute in float32 and cast back to the input dtype, as the
reference does. ``cross_entropy`` waits for the training slice (ROADMAP.md,
queue 1, item 7b).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, cast back to input dtype."""
    xf = x.to(torch.float32)
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return ((xf * rms) * w.to(torch.float32)).to(x.dtype)


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    if name == "swiglu":          # handled by callers with a gate matrix
        return F.silu
    if name == "relu2":
        return _relu2
    if name == "gelu":
        return _gelu_tanh
    raise ValueError(f"unknown activation {name!r}")


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S). Rotates
    the two halves of each head (not interleaved pairs), in float32."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs    # (..., S, Dh/2)
    ang = ang[..., None, :]                                 # (..., S, 1, Dh/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)

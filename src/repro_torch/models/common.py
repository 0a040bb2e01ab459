"""Shared building blocks of the port's models, over plain dict state.

Counterpart of ``repro.models.common``: the same math, in PyTorch. RMSNorm
and RoPE compute in float32 and cast back to the input dtype, as the
reference does. ``cross_entropy`` and ``cross_entropy_sharded`` are the
training loss, in float32. ``dense_init`` draws a projection from
``repro_torch.draws``, stacked on leading axes: each stacked weight is one
draw, where the reference ``vmap``s one draw a layer.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.draws import Stream

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def dense_init(draws: Stream, lead: tuple, d_in: int, d_out: int,
               dtype: torch.dtype, scale: float | None = None
               ) -> torch.Tensor:
    """Truncated-normal fan-in init of a ``lead + (d_in, d_out)`` stack."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    return draws.truncated_normal(tuple(lead) + (d_in, d_out), scale, dtype)


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
    return rotate(x, positions, rope_freqs(x.shape[-1], theta, x.device))


def yarn_freqs(dim: int, theta: float, factor: float, original_max: int,
               beta_fast: float, beta_slow: float, device=None
               ) -> torch.Tensor:
    """YaRN's RoPE frequencies (DeepSeek-V2's ``DeepseekV2YarnRotary
    Embedding``): ``theta``'s frequencies where a pair turns more than
    ``beta_fast`` times over ``original_max`` positions, those divided by
    ``factor`` where it turns fewer than ``beta_slow`` times, a linear
    ramp over the pairs between."""
    def dim_of(turns: float) -> float:
        return dim * math.log(original_max / (turns * 2 * math.pi)) \
            / (2 * math.log(theta))

    low = max(math.floor(dim_of(beta_fast)), 0)
    high = min(math.ceil(dim_of(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    base = theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=device) / dim)
    extra, inter = 1.0 / base, 1.0 / (factor * base)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp                 # the share of the unscaled frequency
    return inter * (1.0 - keep) + extra * keep


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature: ``0.1 mscale ln(factor) + 1``."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def rotate(x: torch.Tensor, positions: torch.Tensor,
           freqs: torch.Tensor) -> torch.Tensor:
    """``apply_rope`` at the frequencies ``freqs`` (Dh/2,)."""
    ang = positions[..., None].to(torch.float32) * freqs    # (..., S, Dh/2)
    ang = ang[..., None, :]                                 # (..., S, 1, Dh/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask=None) -> torch.Tensor:
    """Mean CE over (possibly masked) positions. logits: (..., V) any dtype."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def cross_entropy_sharded(logits: torch.Tensor, labels: torch.Tensor,
                          mask=None) -> torch.Tensor:
    """The reference's CE for vocab-sharded logits: logsumexp by max and
    sum, the gold logit by a one-hot contraction instead of a gather. On
    one device it is ``cross_entropy`` computed another way."""
    lf = logits.to(torch.float32)
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    logz = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    onehot = F.one_hot(labels.long(), lf.shape[-1]).to(lf.dtype)
    gold = (lf * onehot).sum(dim=-1)
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)

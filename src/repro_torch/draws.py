"""Random draws that do not depend on the device.

A ``torch.Generator`` is Philox on the card and mt19937 on the CPU, so one
seed gives other numbers on each. The port's random state (parameters,
query keys, prompts) comes from here instead: a counter-based generator in
int64 tensor arithmetic, whose integers are the same on any device, and a
float transform made only of correctly rounded operations, so its values
are the same bit for bit too.

- Integers: element ``i`` of a draw hashes the counter ``start + i`` with
  two rounds of a 32-bit avalanche mix (Wellons' hash-prospector
  constants 0x21f0aaad, 0x735a2d97) keyed by the seed. Each product is
  taken on 16-bit halves of the constant, so no int64 product overflows.
- Truncated normal on [-2, 2]: the inverse CDF, tabulated once at 2**16 + 1
  points in float64 on the CPU and kept in float32, read at the top 16 of
  24 random bits and interpolated linearly by the low 8: a gather, one
  product and one sum, each rounded the same way on either device. The
  result is within 1e-7 of the exact inverse CDF (float32's rounding of
  the table; the interpolation itself adds 2e-8).
- Normal (untruncated): the same 24 random bits and the same read of a
  table, of the standard normal's inverse CDF over the whole mass
  (``torch.special.ndtri`` in float64 on the CPU, kept in float32). The
  outer ``_TAIL_CELLS`` cells at either end, whose curvature the
  interpolation would not follow, read a second table that holds the
  exact value of each of their 24-bit points instead. Values lie within
  +-5.42 (the midpoint of the outermost 24-bit cell) and within 8e-7 of
  the exact inverse CDF.

``Stream`` hands out consecutive counter ranges, so successive draws of one
seed never reuse a counter.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

_M32 = 0xFFFFFFFF
_CHUNK = 1 << 25               # elements hashed at a time: bounds temporaries
_TABLE_BITS = 16               # inverse-CDF table: 2**16 intervals
_FRAC_BITS = 8                 # interpolation bits below the table index
_TAIL_CELLS = 256              # normal: table cells at either end read exactly


def _mul32(x, c: int):
    """``x * c mod 2**32`` for ``0 <= x < 2**32``: the products stay below
    2**48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit avalanche mix; on Python ints or int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x21F0AAAD)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x735A2D97)
    return x ^ (x >> 15)


def _keys(seed: int) -> Tuple[int, int]:
    k1 = _mix32((seed ^ 0x243F6A88) & _M32)
    return k1, _mix32(k1 ^ ((seed >> 32) & _M32) ^ 0x85A308D3)


def bits32(seed: int, start: int, n: int, device) -> torch.Tensor:
    """(n,) int64 in [0, 2**32): the hashes of counters ``start`` ..
    ``start + n - 1`` under ``seed``."""
    k1, k2 = _keys(seed)
    out = torch.empty(n, dtype=torch.int64, device=device)
    for a in range(0, n, _CHUNK):
        c = torch.arange(start + a, start + min(a + _CHUNK, n),
                         dtype=torch.int64, device=device)
        h = _mix32((c & _M32) ^ k1)
        out[a:a + _CHUNK] = _mix32(h ^ ((c >> 32) & _M32) ^ k2)
    return out


@functools.lru_cache(maxsize=None)
def _inverse_cdf() -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, steps) float32 on the CPU: the standard normal's inverse CDF
    truncated to [-2, 2] at 2**16 + 1 evenly spaced points of its mass, and
    the differences of neighbours."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    s = torch.arange((1 << _TABLE_BITS) + 1, dtype=torch.float64) \
        / (1 << _TABLE_BITS)
    z = torch.erfinv(2.0 * (lo + s * (hi - lo)) - 1.0) * math.sqrt(2.0)
    z = z.clamp(-2.0, 2.0).to(torch.float32)
    return z, z[1:] - z[:-1]


@functools.lru_cache(maxsize=None)
def _normal_tables() -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(values, steps, tail) float32 on the CPU: the standard normal's
    inverse CDF at 2**16 + 1 evenly spaced points of its mass (the two
    infinite ends set to 0: only the tail table reads those cells), the
    differences of neighbours, and the exact values at the midpoints of
    the 24-bit cells of the lowest ``_TAIL_CELLS`` table cells (the highest
    are their negatives, by symmetry)."""
    n = 1 << _TABLE_BITS
    s = torch.arange(n + 1, dtype=torch.float64) / n
    z = torch.special.ndtri(s)
    z[0] = z[-1] = 0.0
    z = z.to(torch.float32)
    k = torch.arange(_TAIL_CELLS << _FRAC_BITS, dtype=torch.float64)
    tail = torch.special.ndtri((k + 0.5) / (1 << 24)).to(torch.float32)
    return z, z[1:] - z[:-1], tail


class Stream:
    """Draws of one seed, each from the next unused counters."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.counter = 0

    def bits32(self, n: int) -> torch.Tensor:
        out = bits32(self.seed, self.counter, n, self.device)
        self.counter += n
        return out

    def _shape_only(self, shape, n: int, dtype: torch.dtype
                    ) -> torch.Tensor:
        """A draw on the ``meta`` device: its counters are used up and its
        shape and dtype made, with no values to compute."""
        self.counter += n
        return torch.empty(shape, dtype=dtype, device=self.device)

    def truncated_normal(self, shape, scale: float,
                         dtype: torch.dtype) -> torch.Tensor:
        """Truncated normal on [-2, 2] times ``scale``, computed in float32
        and cast to ``dtype``."""
        n = math.prod(shape)
        if self.device.type == "meta":
            return self._shape_only(shape, n, dtype)
        values, steps = (t.to(self.device) for t in _inverse_cdf())
        out = torch.empty(n, dtype=dtype, device=self.device)
        for a in range(0, n, _CHUNK):
            k = self.bits32(min(_CHUNK, n - a)) >> 8        # 24 random bits
            idx = k >> _FRAC_BITS
            # the midpoint of the 24-bit cell: exact in float32
            frac = ((k & ((1 << _FRAC_BITS) - 1)).to(torch.float32) + 0.5) \
                * (1.0 / (1 << _FRAC_BITS))
            z = values[idx] + steps[idx] * frac
            out[a:a + _CHUNK] = (z * scale).to(dtype)
        return out.reshape(shape)

    def normal(self, shape, scale: float,
               dtype: torch.dtype) -> torch.Tensor:
        """Standard normal times ``scale`` (the reference's
        ``jax.random.normal`` initialisations), computed in float32 and
        cast to ``dtype``."""
        n = math.prod(shape)
        if self.device.type == "meta":
            return self._shape_only(shape, n, dtype)
        values, steps, tail = (t.to(self.device) for t in _normal_tables())
        n_tail = tail.numel()
        top = (1 << 24) - 1
        out = torch.empty(n, dtype=dtype, device=self.device)
        for a in range(0, n, _CHUNK):
            k = self.bits32(min(_CHUNK, n - a)) >> 8        # 24 random bits
            idx = k >> _FRAC_BITS
            frac = ((k & ((1 << _FRAC_BITS) - 1)).to(torch.float32) + 0.5) \
                * (1.0 / (1 << _FRAC_BITS))
            z = values[idx] + steps[idx] * frac
            low, high = k < n_tail, k > top - n_tail
            z = torch.where(low, tail[k.clamp(max=n_tail - 1)], z)
            z = torch.where(high, -tail[(top - k).clamp(max=n_tail - 1)], z)
            out[a:a + _CHUNK] = (z * scale).to(dtype)
        return out.reshape(shape)

    def randint(self, high: int, shape) -> torch.Tensor:
        """int64 in [0, high), ``high`` below 2**31."""
        if not 0 < high < 1 << 31:
            raise ValueError(f"high={high} is not in (0, 2**31)")
        return ((self.bits32(math.prod(shape)) * high) >> 32).reshape(shape)

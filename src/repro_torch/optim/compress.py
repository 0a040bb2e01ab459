"""int8 gradient compression with error feedback.

Counterpart of ``repro.optim.compress``: each gradient leaf is quantized to
int8 with a per-leaf float32 scale, and the quantization residual goes into
an error-feedback buffer that is added back the next step (EF-SGD: the sum
of applied updates is unbiased). ``torch.round`` rounds half to even, as
``jnp.round`` does, so ``q`` and ``scale`` equal the reference's bit for
bit. The reference compresses what crosses the data-parallel axis; on one
device the step applies the round trip all the same.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import tree


def quantize_leaf(g: torch.Tensor, ef: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (q int8, scale f32 scalar, new error-feedback buffer)."""
    gf = g.to(torch.float32) + ef.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, (gf - deq).to(ef.dtype)


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads, ef_state):
    """Apply EF-int8 compression to a gradient tree.

    Returns (dequantized grads, new ef_state, wire_bytes_saved_fraction).
    """
    flat, treedef = tree.flatten_with_path(grads)
    ef_flat = tree.leaves(ef_state)
    out, new_ef = [], []
    for (_, g), ef in zip(flat, ef_flat):
        q, scale, ef2 = quantize_leaf(g, ef)
        out.append(dequantize_leaf(q, scale).to(g.dtype))
        new_ef.append(ef2)
    saved = 1.0 - 1.0 / flat[0][1].element_size()
    return (tree.unflatten(treedef, out), tree.unflatten(treedef, new_ef),
            saved)


def ef_init(grads_like):
    """Zero float32 error-feedback buffers shaped like ``grads_like``."""
    return tree.map_leaves(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like)

"""The model weights of a cell, made from ``--seed`` on the device.

The benchmark makes the weights itself and hands the same values to the
port and to the reference: the layout below is the tree that the port's
``init_params`` describes (each driver checks it against the port's tree
on the ``meta`` device), and every value comes from one
``torch.Generator`` seeded from the run's seed. All bfloat16 leaves are
slices of one buffer drawn by one ``normal_`` call (float32 leaves: a
second buffer), clipped at +-2 and scaled by the port's fan-in scales; the
norms are ones. Each slice starts on a 256-byte boundary, as a tensor of
its own would.

This module imports nothing of the port: the reference makes the same
weights again from the seed with it.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from hrmbench.seeds import derive

WEIGHT_STREAM = 1
_ALIGN = 256                                  # bytes

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def layout(c: dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str,
                                  float]]:
    """``[(path, shape, dtype name, scale)]`` of a dense/MoE decoder with
    stacked layers; scale 0.0 marks a leaf of ones (a norm)."""
    L, D, V = c["n_layers"], c["d_model"], c["vocab_size"]
    H, K = c["n_heads"], c["n_kv_heads"]
    dh = D // H
    pdt = c["param_dtype"]
    out = [
        (("blocks", "norm1"), (L, D), pdt, 0.0),
        (("blocks", "norm2"), (L, D), pdt, 0.0),
        (("blocks", "attn", "wq"), (L, D, H * dh), pdt, 1 / math.sqrt(D)),
        (("blocks", "attn", "wk"), (L, D, K * dh), pdt, 1 / math.sqrt(D)),
        (("blocks", "attn", "wv"), (L, D, K * dh), pdt, 1 / math.sqrt(D)),
        (("blocks", "attn", "wo"), (L, H * dh, D), pdt,
         1 / math.sqrt(H * dh * 2 * L)),
    ]
    moe = c.get("moe")
    if moe:
        E, Fe, ns = moe["n_experts"], moe["d_expert"], moe.get("n_shared", 0)
        out += [
            (("blocks", "moe", "router"), (L, D, E), "float32", 0.02),
            (("blocks", "moe", "wi"), (L, E, D, Fe), pdt, 1 / math.sqrt(D)),
            (("blocks", "moe", "wg"), (L, E, D, Fe), pdt, 1 / math.sqrt(D)),
            (("blocks", "moe", "wo"), (L, E, Fe, D), pdt,
             1 / math.sqrt(Fe * 2 * L)),
        ]
        if ns:
            Fs = ns * Fe
            out += [
                (("blocks", "moe", "shared", "wi"), (L, D, Fs), pdt,
                 1 / math.sqrt(D)),
                (("blocks", "moe", "shared", "wo"), (L, Fs, D), pdt,
                 1 / math.sqrt(Fs * 2 * L)),
                (("blocks", "moe", "shared", "wg"), (L, D, Fs), pdt,
                 1 / math.sqrt(D)),
            ]
    else:
        F = c["d_ff"]
        out += [
            (("blocks", "mlp", "wi"), (L, D, F), pdt, 1 / math.sqrt(D)),
            (("blocks", "mlp", "wo"), (L, F, D), pdt,
             1 / math.sqrt(F * 2 * L)),
            (("blocks", "mlp", "wg"), (L, D, F), pdt, 1 / math.sqrt(D)),
        ]
    out += [
        (("embed",), (V, D), pdt, 0.02),
        (("final_norm",), (D,), pdt, 0.0),
        (("head",), (D, V), pdt, 1 / math.sqrt(D)),
    ]
    return out


def _aligned(n: int, dtype: torch.dtype) -> int:
    step = _ALIGN // dtype.itemsize
    return -(-n // step) * step


def make(c: dict, seed: int, device) -> Dict:
    """The weights as the nested dict the port takes, on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, WEIGHT_STREAM))
    spec = layout(c)
    flats = {}
    for name in ("float32", "bfloat16"):           # fixed draw order
        dt = DTYPES[name]
        total = sum(_aligned(math.prod(shape), dt)
                    for _, shape, d, scale in spec if d == name and scale)
        if total:
            flat = torch.empty(total, dtype=dt, device=device)
            flat.normal_(generator=gen).clamp_(-2.0, 2.0)
            flats[name] = [flat, 0]
    tree: Dict = {}
    for path, shape, name, scale in spec:
        dt = DTYPES[name]
        n = math.prod(shape)
        if scale:
            flat, off = flats[name]
            leaf = flat[off:off + n].view(shape).mul_(scale)
            flats[name][1] = off + _aligned(n, dt)
        else:
            leaf = torch.ones(shape, dtype=dt, device=device)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def flat_leaves(tree: Dict, prefix: Tuple[str, ...] = ()):
    """``[(path, leaf)]`` with keys sorted at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += flat_leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out

"""The port's transformer, dense family: ``init_params``, ``init_cache``,
``forward``, ``loss_fn`` and ``decode_step``.

Counterpart of ``repro.models.transformer``: the same tree, key paths,
shapes and dtypes, with per-layer weights stacked on a leading layer axis.
Values come from ``repro_torch.draws`` seeded with ``seed``: truncated
normal on [-2, 2] times the reference's scales (fan-in for projections,
0.02 for the embedding, depth-scaled output projections), the same bit for
bit on the card and on the CPU. They cannot equal ``jax.random``'s draws;
tests that compare the two packages carry the reference's state across
with ``convert``.

``forward`` is the reference's full-sequence forward, ``loss_fn`` its
training loss (cross-entropy on ``forward``'s logits) and ``decode_step``
its one-token decode against the cache, for the dense family and the
token frontend: the reference's ``lax.scan`` over the stacked layer axis
becomes a Python loop over layer slices (views, no copies; under autograd
one ``unbind`` a leaf, whose backward stacks the layer gradients once).
``remat`` wraps each layer as the reference's ``jax.checkpoint`` does:
``"full"`` saves nothing of a layer, ``"dots"`` saves its matrix
products. The other families and frontends wait for ROADMAP.md, queue 1,
item 12.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.draws import Stream
from repro_torch.models.attention import attn_apply, attn_decode
from repro_torch.models.common import (cross_entropy, cross_entropy_sharded,
                                       dtype_of, rmsnorm)
from repro_torch.models.mlp import mlp_apply

Params = Dict[str, Any]

def _dense_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.frontend != "none":
        raise NotImplementedError(
            f"family {cfg.family!r} with frontend {cfg.frontend!r} is not "
            "ported yet (ROADMAP.md, queue 1, item 12); the port runs the "
            "dense family on tokens")


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> Params:
    """Random parameters of a dense model, on ``device`` (the card unless
    given)."""
    _dense_family(cfg)
    dev = resolve_device(device)
    draws = Stream(seed, dev)
    pdt = dtype_of(cfg.param_dtype)
    L, D, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    dh, H, K = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    def normal(shape, scale: float) -> torch.Tensor:
        return draws.truncated_normal(shape, scale, pdt)

    def dense(*shape, scale=None) -> torch.Tensor:
        return normal(shape, 1.0 / math.sqrt(shape[-2]) if scale is None
                      else scale)

    def ones(*shape) -> torch.Tensor:
        return torch.ones(shape, dtype=pdt, device=dev)

    attn = {"wq": dense(L, D, H * dh), "wk": dense(L, D, K * dh),
            "wv": dense(L, D, K * dh),
            "wo": dense(L, H * dh, D,
                        scale=1.0 / math.sqrt(H * dh * 2 * L))}
    if cfg.qkv_bias:
        attn.update(bq=torch.zeros((L, H * dh), dtype=pdt, device=dev),
                    bk=torch.zeros((L, K * dh), dtype=pdt, device=dev),
                    bv=torch.zeros((L, K * dh), dtype=pdt, device=dev))
    out_scale = 1.0 / math.sqrt(F * 2 * L)
    mlp = {"wi": dense(L, D, F), "wo": dense(L, F, D, scale=out_scale)}
    if cfg.act == "swiglu":
        mlp["wg"] = dense(L, D, F)
    p: Params = {
        "embed": normal((V, D), 0.02),
        "blocks": {"norm1": ones(L, D), "attn": attn, "norm2": ones(L, D),
                   "mlp": mlp},
        "final_norm": ones(D),
    }
    if not cfg.tie_embeddings:
        p["head"] = dense(D, V)
    return p


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device=None) -> Dict[str, torch.Tensor]:
    """Decode cache sized for ``max_seq`` positions, zero-filled, on
    ``device`` (the card unless given)."""
    _dense_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    cdt = dtype_of(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=cdt, device=dev),
            "v": torch.zeros(shape, dtype=cdt, device=dev)}


# ================================================================ forward
def _embed_inputs(p: Params, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig) -> torch.Tensor:
    """The token embeddings (B,S,D) in the compute dtype."""
    return p["embed"][batch["tokens"]].to(dtype_of(cfg.compute_dtype))


def _head(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rmsnorm(x, p["final_norm"], cfg.norm_eps)
    w = p["embed"].T if cfg.tie_embeddings else p["head"]
    return x @ w.to(dtype_of(cfg.compute_dtype))


def _unstack(tree, n: int):
    """The stacked per-layer weights as ``n`` per-layer dicts of views:
    one ``unbind`` a leaf, so autograd stacks the layer gradients once
    instead of adding a full-size gradient for every layer."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return tree.unbind(0)


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
             torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``"dots"``: keep matrix products,
    recompute the rest (``jax.checkpoint_policies.checkpoint_dots``)."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in _PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn: Callable, remat: str) -> Callable:
    """``fn`` under the activation-checkpoint policy ``remat``."""
    if remat == "none" or not remat:
        return fn
    if remat == "dots":
        try:
            from torch.utils.checkpoint import \
                create_selective_checkpoint_contexts
        except ImportError as e:
            raise NotImplementedError(
                "remat='dots' needs torch.utils.checkpoint's selective "
                "checkpointing, which this PyTorch lacks (ROADMAP.md, "
                "queue 1, item 7b)") from e

        def context():
            return create_selective_checkpoint_contexts(_save_products)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=context)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)  # "full"


def forward(p: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: str = "none", return_cache: bool = False):
    """Full-sequence forward. Returns (logits, aux_loss, cache|None); the
    cache is ``{"k", "v"}`` of shape (L,B,S,K,dh)."""
    _dense_family(cfg)
    x = _embed_inputs(p, batch, cfg)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]

    def body(x, layer):
        h, (k, v) = attn_apply(
            layer["attn"], rmsnorm(x, layer["norm1"], cfg.norm_eps), cfg,
            positions)
        x = x + h
        x = x + mlp_apply(
            layer["mlp"], rmsnorm(x, layer["norm2"], cfg.norm_eps), cfg)
        return x, k, v

    step = _maybe_remat(body, remat)
    ks, vs = [], []
    for layer in _unstack(p["blocks"], cfg.n_layers):
        x, k, v = step(x, layer)
        if return_cache:
            ks.append(k)
            vs.append(v)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)} \
        if return_cache else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(p, x, cfg), aux, cache


# =================================================================== loss
def loss_fn(p: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: str = "none"):
    """(loss, {"ce", "aux"}): mean next-token cross-entropy in float32 over
    ``batch["labels"]`` (masked by ``batch["mask"]`` when given)."""
    logits, aux, _ = forward(p, batch, cfg, remat=remat)
    labels = batch["labels"]
    mask = batch.get("mask")
    if cfg.shard_hints:
        ce = cross_entropy_sharded(logits, labels, mask)
    else:
        ce = cross_entropy(logits, labels, mask)
    aux_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
    loss = ce + aux_w * aux / max(cfg.n_layers, 1)
    return loss, {"ce": ce, "aux": aux}


# ============================================================ decode step
def decode_step(p: Params, token: torch.Tensor, pos: int,
                cache: Dict[str, torch.Tensor], cfg: ModelConfig):
    """token: (B,) int; pos: the token's position -> (logits (B,V), cache).

    Each layer writes its new k/v into ``cache`` in place (layer views of
    the stacked (L,B,Smax,K,dh) tensors), so the returned cache is the one
    passed in."""
    _dense_family(cfg)
    x = p["embed"][token][:, None, :].to(dtype_of(cfg.compute_dtype))
    for i, layer in enumerate(_unstack(p["blocks"], cfg.n_layers)):
        h, _, _ = attn_decode(
            layer["attn"], rmsnorm(x, layer["norm1"], cfg.norm_eps),
            cache["k"][i], cache["v"][i], pos, cfg)
        x = x + h
        x = x + mlp_apply(
            layer["mlp"], rmsnorm(x, layer["norm2"], cfg.norm_eps), cfg)
    return _head(p, x, cfg)[:, 0], cache

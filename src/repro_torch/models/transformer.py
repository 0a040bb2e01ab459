"""The port's model: ``init_params``, ``init_cache``, ``forward``,
``loss_fn`` and ``decode_step`` for every family of the reference.

Counterpart of ``repro.models.transformer``: the same trees, key paths,
shapes and dtypes, with per-layer weights stacked on leading axes.

  dense | moe  attention + (MLP | MoE) blocks; ``forward``'s ``aux`` sums
               the MoE layers' load-balancing losses. Under an
               ``MLAConfig`` (the port's own, DeepSeek-V2) the attention
               is ``models/mla.py``'s latent attention, the first
               ``n_dense_layers`` blocks (``dense_blocks``) have a dense
               MLP and the rest (``blocks``) the MoE, and the cache holds
               one ``latent`` a token and layer.
  audio        (hubert) the dense blocks, bidirectional where
               ``cfg.causal`` is false and without RoPE, over precomputed
               frame embeddings projected by ``frame_proj`` (no ``embed``);
               it does not decode.
  vlm          (llava) the dense blocks over precomputed patch embeddings
               projected by ``patch_proj`` and prepended to the text
               tokens; the loss covers the text positions only, and
               decoding continues after the patch-prefixed prefill.
  hybrid       (zamba2) Mamba2 mixer layers; one *shared* attention + MLP
               block (one weight set) runs before every ``attn_every``-layer
               group, with a KV cache of its own per group.
  ssm          (xlstm) groups of ``slstm_every - 1`` mLSTM blocks and one
               sLSTM block, stacked ``blocks_m`` (G, K-1, ...) and
               ``blocks_s`` (G, ...).

Values come from ``repro_torch.draws`` seeded with ``seed``: truncated
normal on [-2, 2] times the reference's scales (fan-in for projections,
0.02 for the embedding and the router, depth-scaled output projections),
normal for the reference's ``jax.random.normal`` draws (the convs, the
sLSTM's recurrent weights), the same bit for bit on the card and on the
CPU. They cannot equal ``jax.random``'s draws; tests that compare the two
packages carry the reference's state across with ``convert``.

The reference's ``lax.scan`` over stacked layers becomes a Python loop
over layer slices (views, no copies; under autograd one ``unbind`` a
leaf, whose backward stacks the layer gradients once). ``remat`` wraps
each layer (each mixer layer of hybrid and xLSTM, as the reference does)
as the reference's ``jax.checkpoint`` does: ``"full"`` saves nothing of a
layer, ``"dots"`` saves its matrix products. ``decode_step`` writes the
caches and recurrent states it is given in place and returns them.
``paged_decode_step`` and ``prefill_write`` are ``decode_step`` and
``forward`` over the serving engine's paged pools, which are
``init_cache``'s leaves with pages as the batch: the attention layout is
decided here for both.

The reference's layout hints under ``shard_hints`` change no value and
have no counterpart here (``models/attention.py`` says why); its sharded
cross-entropy under ``shard_hints`` is ``cross_entropy_sharded``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import telemetry
from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig, is_mla
from repro_torch.draws import Stream
from repro_torch.models import mamba2, mla, query_graph, xlstm
from repro_torch.kernels.paged_attn import paged_attn_decode
from repro_torch.models.attention import (_project_qkv, attn_apply,
                                          attn_decode, attn_init)
from repro_torch.models.common import (cross_entropy, cross_entropy_sharded,
                                       dense_init, dtype_of, rmsnorm)
from repro_torch.models.mlp import mlp_apply, mlp_init, moe_apply, moe_init

Params = Dict[str, Any]
_ATTN_FAMILIES = ("dense", "moe", "audio", "vlm")
_KV_FAMILIES = ("dense", "moe", "vlm")      # attention families that decode


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family not in _ATTN_FAMILIES + ("hybrid", "ssm"):
        raise ValueError(cfg.family)


def _ssm_groups(cfg: ModelConfig):
    """(G, K): xLSTM groups of K blocks, the last of each an sLSTM."""
    K = cfg.xlstm.slstm_every
    if cfg.n_layers % K:
        raise ValueError(f"n_layers={cfg.n_layers} is not a multiple of "
                         f"slstm_every={K}")
    return cfg.n_layers // K, K


# ========================================================= initialization
def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> Params:
    """Random parameters on ``device`` (the card unless given). The blocks
    are drawn first, then the embedding (``frame_proj`` in its place under
    the audio frontend), then the head, then ``patch_proj`` under the
    vision frontend."""
    _check_ported(cfg)
    dev = resolve_device(device)
    draws = Stream(seed, dev)
    pdt = dtype_of(cfg.param_dtype)
    L, D = cfg.n_layers, cfg.d_model

    def ones(*shape) -> torch.Tensor:
        return torch.ones(shape, dtype=pdt, device=dev)

    p: Params = {}
    if is_mla(cfg):
        n_dense = cfg.n_dense_layers
        for key, n, ffn in (("dense_blocks", n_dense, "mlp"),
                            ("blocks", L - n_dense, "moe")):
            p[key] = {"norm1": ones(n, D),
                      "attn": mla.mla_init(draws, cfg, (n,)),
                      "norm2": ones(n, D),
                      ffn: (mlp_init if ffn == "mlp" else moe_init)(
                          draws, cfg, (n,))}
    elif cfg.family in _ATTN_FAMILIES:
        blocks = {"norm1": ones(L, D), "attn": attn_init(draws, cfg, (L,)),
                  "norm2": ones(L, D)}
        if cfg.family == "moe":
            blocks["moe"] = moe_init(draws, cfg, (L,))
        else:
            blocks["mlp"] = mlp_init(draws, cfg, (L,))
        p["blocks"] = blocks
    elif cfg.family == "hybrid":
        p["blocks"] = {"norm": ones(L, D),
                       "mamba": mamba2.mamba_init(draws, cfg, (L,))}
        p["shared"] = {"norm1": ones(D), "attn": attn_init(draws, cfg),
                       "norm2": ones(D), "mlp": mlp_init(draws, cfg)}
    else:
        G, K = _ssm_groups(cfg)
        p["blocks_m"] = {"norm": ones(G, K - 1, D),
                         "mlstm": xlstm.mlstm_init(draws, cfg, (G, K - 1))}
        p["blocks_s"] = {"norm": ones(G, D),
                         "slstm": xlstm.slstm_init(draws, cfg, (G,))}
    if cfg.frontend == "audio_frames":
        p["frame_proj"] = dense_init(draws, (), D, D, pdt)
    else:
        p["embed"] = draws.truncated_normal((cfg.vocab_size, D), 0.02, pdt)
    p["final_norm"] = ones(D)
    if not cfg.tie_embeddings:
        p["head"] = dense_init(draws, (), D, cfg.vocab_size, pdt)
    if cfg.frontend == "vision_patches":
        p["patch_proj"] = dense_init(draws, (), D, D, pdt)
    return p


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device=None) -> Dict[str, torch.Tensor]:
    """Decode cache sized for ``max_seq`` positions, on ``device`` (the
    card unless given): the KV caches zero-filled, the recurrent states at
    their initial values. The audio family does not decode and raises the
    reference's ``ValueError``."""
    _check_ported(cfg)
    if cfg.family == "audio":
        raise ValueError(f"family {cfg.family} does not decode")
    dev = resolve_device(device)
    cdt = dtype_of(cfg.compute_dtype)
    kv = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)

    def zeros(*shape, dtype=cdt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def rep(lead: tuple, a: torch.Tensor) -> torch.Tensor:
        return a.expand(lead + a.shape).contiguous()

    if is_mla(cfg):
        return {"latent": zeros(cfg.n_layers, batch, max_seq,
                                cfg.latent_dim)}
    if cfg.family in _KV_FAMILIES:
        return {"k": zeros(cfg.n_layers, *kv), "v": zeros(cfg.n_layers, *kv)}
    if cfg.family == "hybrid":
        G = cfg.n_layers // cfg.attn_every
        conv, ssm_st = mamba2.mamba_state_init(cfg, batch, dev)
        return {"mamba_conv": rep((cfg.n_layers,), conv),
                "mamba_ssm": rep((cfg.n_layers,), ssm_st),
                "attn_k": zeros(G, *kv), "attn_v": zeros(G, *kv)}
    G, K = _ssm_groups(cfg)
    conv, c_st = xlstm.mlstm_state_init(cfg, batch, dev)
    s_c, s_n, s_h, s_m = xlstm.slstm_state_init(cfg, batch, dev)
    return {"m_conv": rep((G, K - 1), conv), "m_c": rep((G, K - 1), c_st),
            "s_c": rep((G,), s_c), "s_n": rep((G,), s_n),
            "s_h": rep((G,), s_h), "s_m": rep((G,), s_m)}


# ================================================================ forward
def _embed_inputs(p: Params, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig):
    """(x (B,S,D) in the compute dtype, the loss mask or None, the label
    offset): the projected frames under the audio frontend; under the
    vision frontend the projected patches (B,P,D) before the token
    embeddings, the offset P."""
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.frontend == "audio_frames":
        x = batch["frames"].to(cdt) @ p["frame_proj"].to(cdt)
        return x, batch.get("mask"), 0
    tok = p["embed"][batch["tokens"]].to(cdt)
    if cfg.frontend == "vision_patches":
        patches = batch["patches"].to(cdt) @ p["patch_proj"].to(cdt)
        return torch.cat([patches, tok], dim=1), batch.get("mask"), \
            patches.shape[1]
    return tok, batch.get("mask"), 0


def _head(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    with telemetry.inner("model.head"):
        x = rmsnorm(x, p["final_norm"], cfg.norm_eps)
        w = p["embed"].T if cfg.tie_embeddings else p["head"]
        return x @ w.to(dtype_of(cfg.compute_dtype))


def _layers(p: Params, cfg: ModelConfig):
    """The attention families' per-layer weights in order: under an
    ``MLAConfig`` the dense blocks, then the MoE blocks."""
    if not is_mla(cfg):
        return _unstack(p["blocks"], cfg.n_layers)
    n_dense = cfg.n_dense_layers
    return _unstack(p["dense_blocks"], n_dense) \
        + _unstack(p["blocks"], cfg.n_layers - n_dense)


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
    cache holds ``init_cache``'s leaves, sized to the sequence. Inside a
    campaign query the call goes to its ``query_graph.QueryGraph``, which
    replays the captured forward where it can."""
    if query_graph.active is not None:
        return query_graph.active.forward(forward, p, batch, cfg, remat,
                                          return_cache)
    _check_ported(cfg)
    x, _, _ = _embed_inputs(p, batch, cfg)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    eps = cfg.norm_eps
    cache = None

    if cfg.family in _ATTN_FAMILIES:
        latent = is_mla(cfg)

        def body(x, layer):
            with telemetry.inner("layer.attn"):
                hn = rmsnorm(x, layer["norm1"], eps)
                if latent:
                    h, kv = mla.mla_apply(layer["attn"], hn, cfg, positions)
                    kv = (kv,)
                else:
                    h, kv = attn_apply(layer["attn"], hn, cfg, positions)
                x = x + h
            with telemetry.inner("layer.ffn"):
                hn = rmsnorm(x, layer["norm2"], eps)
                if "moe" in layer:
                    h, a = moe_apply(layer["moe"], hn, cfg)
                else:
                    h, a = mlp_apply(layer["mlp"], hn, cfg), None
                return (x + h, a) + kv

        step = _maybe_remat(body, remat)
        kvs = []
        for layer in _layers(p, cfg):
            x, a, *kv = step(x, layer)
            if a is not None:
                aux = aux + a
            if return_cache:
                kvs.append(kv)
        if return_cache:
            names = ("latent",) if latent else ("k", "v")
            cache = {n: torch.stack([kv[j] for kv in kvs])
                     for j, n in enumerate(names)}

    elif cfg.family == "hybrid":
        shared = p["shared"]

        def inner(x, layer):
            h, (conv, ssm_st) = mamba2.mamba_apply(
                layer["mamba"], rmsnorm(x, layer["norm"], eps), cfg)
            return x + h, conv, ssm_st

        step = _maybe_remat(inner, remat)
        layers = _unstack(p["blocks"], cfg.n_layers)
        sts = {"mamba_conv": [], "mamba_ssm": [], "attn_k": [],
               "attn_v": []}
        for g in range(cfg.n_layers // cfg.attn_every):
            h, (k, v) = attn_apply(shared["attn"],
                                   rmsnorm(x, shared["norm1"], eps), cfg,
                                   positions)
            x = x + h
            x = x + mlp_apply(shared["mlp"],
                              rmsnorm(x, shared["norm2"], eps), cfg)
            if return_cache:
                sts["attn_k"].append(k)
                sts["attn_v"].append(v)
            for layer in layers[g * cfg.attn_every:
                                (g + 1) * cfg.attn_every]:
                x, conv, ssm_st = step(x, layer)
                if return_cache:
                    sts["mamba_conv"].append(conv)
                    sts["mamba_ssm"].append(ssm_st)
        if return_cache:
            cache = {name: torch.stack(v) for name, v in sts.items()}

    else:
        G, K = _ssm_groups(cfg)

        def inner(x, layer):
            h, (conv, c_st) = xlstm.mlstm_apply(
                layer["mlstm"], rmsnorm(x, layer["norm"], eps), cfg)
            return x + h, conv, c_st

        step = _maybe_remat(inner, remat)
        names = ("m_conv", "m_c", "s_c", "s_n", "s_h", "s_m")
        sts = {name: [] for name in names}
        for mgroup, sblock in zip(_unstack(p["blocks_m"], G),
                                  _unstack(p["blocks_s"], G)):
            convs, cs = [], []
            for layer in _unstack(mgroup, K - 1):
                x, conv, c_st = step(x, layer)
                convs.append(conv)
                cs.append(c_st)
            h, sst = xlstm.slstm_apply(
                sblock["slstm"], rmsnorm(x, sblock["norm"], eps), cfg)
            x = x + h
            if return_cache:
                for name, v in zip(names, (torch.stack(convs),
                                           torch.stack(cs)) + tuple(sst)):
                    sts[name].append(v)
        if return_cache:
            cache = {name: torch.stack(v) for name, v in sts.items()}

    return _head(p, x, cfg), aux, cache


# =================================================================== loss
def loss_fn(p: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: str = "none"):
    """(loss, {"ce", "aux"}): mean next-token cross-entropy in float32 over
    ``batch["labels"]`` (masked by ``batch["mask"]`` when given; under the
    vision frontend over the text positions after the patch prefix), plus
    the MoE aux loss weighted by ``router_aux_weight`` per layer."""
    logits, aux, _ = forward(p, batch, cfg, remat=remat)
    labels = batch["labels"]
    if cfg.frontend == "vision_patches":
        logits = logits[:, cfg.n_patches:]
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

    Each layer writes its new k/v (latent), or its new recurrent state, into
    ``cache`` in place (layer views of the stacked tensors), so the
    returned cache is the one passed in. Under the vision frontend ``pos``
    counts the patch prefix. The audio family raises the reference's
    ``ValueError``."""
    _check_ported(cfg)
    x = p["embed"][token][:, None, :].to(dtype_of(cfg.compute_dtype))
    eps = cfg.norm_eps
    if cfg.family == "audio":
        raise ValueError(f"family {cfg.family} does not decode")

    if cfg.family in _KV_FAMILIES:
        latent = is_mla(cfg)
        for i, layer in enumerate(_layers(p, cfg)):
            hn = rmsnorm(x, layer["norm1"], eps)
            if latent:
                c = cache["latent"][i]                # (B, Smax, latent_dim)
                positions = torch.full((x.shape[0], 1), pos,
                                       dtype=torch.int64, device=x.device)
                c[:, pos] = mla.latent(layer["attn"], hn, cfg,
                                       positions)[:, 0]
                valid = (torch.arange(c.shape[1], device=x.device)
                         <= pos).expand(x.shape[0], -1)
                h = mla.mla_decode(layer["attn"], hn, c, valid, cfg,
                                   positions)
            else:
                h, _, _ = attn_decode(layer["attn"], hn, cache["k"][i],
                                      cache["v"][i], pos, cfg)
            x = x + h
            hn = rmsnorm(x, layer["norm2"], eps)
            if "moe" in layer:
                h, _ = moe_apply(layer["moe"], hn, cfg)
            else:
                h = mlp_apply(layer["mlp"], hn, cfg)
            x = x + h

    elif cfg.family == "hybrid":
        shared = p["shared"]
        layers = _unstack(p["blocks"], cfg.n_layers)
        for g in range(cfg.n_layers // cfg.attn_every):
            h, _, _ = attn_decode(
                shared["attn"], rmsnorm(x, shared["norm1"], eps),
                cache["attn_k"][g], cache["attn_v"][g], pos, cfg)
            x = x + h
            x = x + mlp_apply(shared["mlp"],
                              rmsnorm(x, shared["norm2"], eps), cfg)
            for i in range(g * cfg.attn_every, (g + 1) * cfg.attn_every):
                h, (conv, ssm_st) = mamba2.mamba_decode(
                    layers[i]["mamba"], rmsnorm(x, layers[i]["norm"], eps),
                    (cache["mamba_conv"][i], cache["mamba_ssm"][i]), cfg)
                cache["mamba_conv"][i].copy_(conv)
                cache["mamba_ssm"][i].copy_(ssm_st)
                x = x + h

    else:
        G, K = _ssm_groups(cfg)
        for g, (mgroup, sblock) in enumerate(zip(
                _unstack(p["blocks_m"], G), _unstack(p["blocks_s"], G))):
            for j, layer in enumerate(_unstack(mgroup, K - 1)):
                h, (conv, c_st) = xlstm.mlstm_decode(
                    layer["mlstm"], rmsnorm(x, layer["norm"], eps),
                    (cache["m_conv"][g, j], cache["m_c"][g, j]), cfg)
                cache["m_conv"][g, j].copy_(conv)
                cache["m_c"][g, j].copy_(c_st)
                x = x + h
            names = ("s_c", "s_n", "s_h", "s_m")
            h, sst = xlstm.slstm_decode(
                sblock["slstm"], rmsnorm(x, sblock["norm"], eps),
                tuple(cache[n][g] for n in names), cfg)
            for n, v in zip(names, sst):
                cache[n][g].copy_(v)
            x = x + h

    return _head(p, x, cfg)[:, 0], cache


# ============================================== paged decode and prefill
def paged_decode_logits(p: Params, pools: Dict[str, torch.Tensor],
                        table: torch.Tensor, tokens: torch.Tensor,
                        pos: torch.Tensor, cfg: ModelConfig,
                        page_size: int) -> torch.Tensor:
    """``decode_step`` for every slot against paged pools: the logits
    (S, V), each slot's new K/V (latent) written into its page.

    ``pools``: ``init_cache(cfg, n_pages, page_size)``'s leaves; table:
    (S, P) int64 page ids; tokens, pos: (S,) int64. Per layer each slot's
    new K/V (latent) is written into its page first. K/V: the attention
    reads the pools in place through the table up to each slot's ``pos``
    (``kernels.paged_attn``; on CPU tensors its plain version, over the
    gathered view); latent: the slots' pages are gathered into the
    contiguous (S, P*page_size, ...) view. On the CPU the logits are
    ``decode_step``'s bit for bit. Inactive slots (token 0 at pos 0) all
    write the null page at offset 0, which no slot reads unmasked. A MoE
    layer routes all ``S`` slots' tokens together, the idle ones
    included, as the reference's does: under a capacity that drops tokens
    a slot's logits can differ from its batch-1 ``decode_step``."""
    _check_ported(cfg)
    if cfg.family not in _KV_FAMILIES:
        raise ValueError(f"paged decode supports dense/moe/vlm, "
                         f"not {cfg.family!r}")
    latent = is_mla(cfg)
    S, P = table.shape
    smax = P * page_size
    x = p["embed"][tokens][:, None, :].to(dtype_of(cfg.compute_dtype))
    positions = pos[:, None]                                  # (S,1)
    pid = table.gather(1, (pos // page_size)[:, None])[:, 0]  # (S,)
    off = pos % page_size
    if latent:
        cols = torch.arange(smax, device=pos.device)
        valid = cols[None, :] <= pos[:, None]
    for i, layer in enumerate(_layers(p, cfg)):
        with telemetry.inner("layer.attn"):
            h = rmsnorm(x, layer["norm1"], cfg.norm_eps)
            if latent:
                pl = pools["latent"][i]
                pl[pid, off] = mla.latent(layer["attn"], h, cfg,
                                          positions)[:, 0].to(pl.dtype)
                lat = pl[table].reshape(S, smax, pl.shape[-1])
                x = x + mla.mla_decode(layer["attn"], h, lat, valid, cfg,
                                       positions)
            else:
                pk, pv = pools["k"][i], pools["v"][i]
                q, k_new, v_new = _project_qkv(layer["attn"], h, cfg,
                                               positions)
                pk[pid, off] = k_new[:, 0].to(pk.dtype)
                pv[pid, off] = v_new[:, 0].to(pv.dtype)
                o = paged_attn_decode(q[:, 0], pk, pv, table, pos,
                                      page_size)
                x = x + o[:, None].to(x.dtype) \
                    @ layer["attn"]["wo"].to(x.dtype)
        with telemetry.inner("layer.ffn"):
            hn = rmsnorm(x, layer["norm2"], cfg.norm_eps)
            if "moe" in layer:
                x = x + moe_apply(layer["moe"], hn, cfg)[0]
            else:
                x = x + mlp_apply(layer["mlp"], hn, cfg)
    return _head(p, x, cfg)[:, 0]


def paged_decode_step(p: Params, pools: Dict[str, torch.Tensor],
                      table: torch.Tensor, tokens: torch.Tensor,
                      pos: torch.Tensor, cfg: ModelConfig, page_size: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``paged_decode_logits`` -> (greedy next tokens (S,), ok): ok is a
    0-d bool tensor, all logits finite."""
    logits = paged_decode_logits(p, pools, table, tokens, pos, cfg,
                                 page_size)
    return torch.argmax(logits, dim=-1), torch.isfinite(logits).all()


def prefill_write(p: Params, pools: Dict[str, torch.Tensor],
                  tokens: torch.Tensor, true_len: int, pages: torch.Tensor,
                  cfg: ModelConfig, page_size: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill one request and write its prompt's cache leaves into its
    pages of the pools of the same names.

    tokens: (1, Sb) int64, the prompt padded with zeros to whole pages;
    pages: (Sb // page_size,) int64. Returns (first greedy token, ok) as
    0-d tensors. The padded tail is zeroed, so the pages hold what the
    contiguous oracle's zero-initialised cache holds, bit for bit. The
    prompt carries tokens only, so under the vision frontend this fails
    on the missing patches (``KeyError``), as the reference's does."""
    logits, _, cache = forward(p, {"tokens": tokens}, cfg,
                               return_cache=True)
    last = logits[0, true_len - 1]
    for name, pool in pools.items():
        new = cache[name][:, 0]                       # (L, Sb, ...)
        new[:, true_len:] = 0
        pool[:, pages] = new.to(pool.dtype).reshape(
            new.shape[0], pages.shape[0], page_size, *new.shape[2:])
    return torch.argmax(last, dim=-1), torch.isfinite(last).all()

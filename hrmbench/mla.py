"""A DeepSeek-V2 configuration (multi-head latent attention) in the
benchmark: its weights' layout, the weights from ``--seed``, the port's
configuration built from the file, the checks of both against the port,
and its model FLOPs.

The configuration file holds the published ``config.json``'s keys
(``configs/deepseek-v2-lite.json``). The layout is the tree the port's
``init_params`` describes for an ``MLAConfig``: ``dense_blocks`` for the
first ``first_k_dense_replace`` layers (dense SwiGLU), ``blocks`` for the
MoE layers, each with the MLA weights ``wq``, ``wkv_a``, ``kv_norm``,
``wkv_b`` and ``wo`` under ``attn``. The weights are drawn as
``weights.make`` draws them: one ``normal_`` call a dtype over the leaves
in sorted order, clipped at +-2, scaled by the fan-in scales; norms ones.

FLOPs, as ``flops.py`` counts them (the work the model needs; a
multiply-add is 2): per token the projections, the router, the routed and
shared experts or the dense MLP, and the head once for each token whose
logits are used. The prefill's attention is counted decompressed (``Wkv_b``
on every token; scores over ``nope + rope`` and sums over ``v_head_dim``
a head and attended position), the decode's in latent form (``W_UK``
absorbed into the query and ``W_UV`` after the sum, a head's scores and
sums over the ``kv_lora_rank + rope`` latent), as the published model's
inference computes them. Imports nothing of the port at module level.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from hrmbench import weights
from hrmbench.seeds import derive

# keys of the published config.json whose value the port does not model
# otherwise: each must have the value given
FIXED = {"q_lora_rank": None, "hidden_act": "silu", "attention_bias": False,
         "tie_word_embeddings": False, "scoring_func": "softmax",
         "topk_method": "greedy", "n_group": 1, "topk_group": 1,
         "moe_layer_freq": 1, "routed_scaling_factor": 1}


def _dims(c: dict):
    return (c["num_hidden_layers"], c["first_k_dense_replace"],
            c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"],
            c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"])


def layout(c: dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str,
                                  float]]:
    """``[(path, shape, dtype name, scale)]``; scale 0.0 marks a leaf of
    ones (a norm)."""
    L, n_dense, D, H, R, dn, dr, dv = _dims(c)
    V, pdt = c["vocab_size"], c["param_dtype"]
    E, Fe = c["n_routed_experts"], c["moe_intermediate_size"]
    Fs = c["n_shared_experts"] * Fe
    F = c["intermediate_size"]
    out = []
    for key, n in (("dense_blocks", n_dense), ("blocks", L - n_dense)):
        out += [
            ((key, "norm1"), (n, D), pdt, 0.0),
            ((key, "norm2"), (n, D), pdt, 0.0),
            ((key, "attn", "wq"), (n, D, H * (dn + dr)), pdt,
             1 / math.sqrt(D)),
            ((key, "attn", "wkv_a"), (n, D, R + dr), pdt, 1 / math.sqrt(D)),
            ((key, "attn", "kv_norm"), (n, R), pdt, 0.0),
            ((key, "attn", "wkv_b"), (n, R, H * (dn + dv)), pdt,
             1 / math.sqrt(R)),
            ((key, "attn", "wo"), (n, H * dv, D), pdt,
             1 / math.sqrt(H * dv * 2 * L)),
        ]
    n = L - n_dense
    out += [
        (("dense_blocks", "mlp", "wi"), (n_dense, D, F), pdt,
         1 / math.sqrt(D)),
        (("dense_blocks", "mlp", "wg"), (n_dense, D, F), pdt,
         1 / math.sqrt(D)),
        (("dense_blocks", "mlp", "wo"), (n_dense, F, D), pdt,
         1 / math.sqrt(F * 2 * L)),
        (("blocks", "moe", "router"), (n, D, E), "float32", 0.02),
        (("blocks", "moe", "wi"), (n, E, D, Fe), pdt, 1 / math.sqrt(D)),
        (("blocks", "moe", "wg"), (n, E, D, Fe), pdt, 1 / math.sqrt(D)),
        (("blocks", "moe", "wo"), (n, E, Fe, D), pdt,
         1 / math.sqrt(Fe * 2 * L)),
        (("blocks", "moe", "shared", "wi"), (n, D, Fs), pdt,
         1 / math.sqrt(D)),
        (("blocks", "moe", "shared", "wg"), (n, D, Fs), pdt,
         1 / math.sqrt(D)),
        (("blocks", "moe", "shared", "wo"), (n, Fs, D), pdt,
         1 / math.sqrt(Fs * 2 * L)),
        (("embed",), (V, D), pdt, 0.02),
        (("final_norm",), (D,), pdt, 0.0),
        (("head",), (D, V), pdt, 1 / math.sqrt(D)),
    ]
    return sorted(out)


def make(c: dict, seed: int, device) -> Dict:
    """The weights as the nested dict the port takes, on ``device``:
    ``weights.make``'s draw over this layout."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, weights.WEIGHT_STREAM))
    spec = layout(c)
    flats = {}
    for name in ("float32", "bfloat16"):           # fixed draw order
        dt = weights.DTYPES[name]
        total = sum(weights._aligned(math.prod(shape), dt)
                    for _, shape, d, scale in spec if d == name and scale)
        if total:
            flat = torch.empty(total, dtype=dt, device=device)
            flat.normal_(generator=gen).clamp_(-2.0, 2.0)
            flats[name] = [flat, 0]
    tree: Dict = {}
    for path, shape, name, scale in spec:
        dt = weights.DTYPES[name]
        n = math.prod(shape)
        if scale:
            flat, off = flats[name]
            leaf = flat[off:off + n].view(shape).mul_(scale)
            flats[name][1] = off + weights._aligned(n, dt)
        else:
            leaf = torch.ones(shape, dtype=dt, device=device)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def port_config(c: dict):
    """The port's ``MLAConfig`` of a configuration file."""
    from repro_torch.configs.base import MLAConfig, MoEConfig
    for k, v in FIXED.items():
        if c[k] != v:
            raise ValueError(f"{c['name']}: {k} = {c[k]!r}; the port models "
                             f"only {v!r}")
    rs = c["rope_scaling"]
    if rs["type"] != "yarn" or rs["mscale"] != rs["mscale_all_dim"]:
        raise ValueError(f"{c['name']}: the port models YaRN with mscale = "
                         f"mscale_all_dim (a cos/sin factor of 1), not "
                         f"{rs}")
    return MLAConfig(
        name=c["name"], family="moe", n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"], act="swiglu",
        rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
        moe=MoEConfig(n_experts=c["n_routed_experts"],
                      top_k=c["num_experts_per_tok"],
                      d_expert=c["moe_intermediate_size"],
                      n_shared=c["n_shared_experts"],
                      capacity_factor=c["capacity_factor"]),
        param_dtype=c["param_dtype"], compute_dtype=c["compute_dtype"],
        kv_lora_rank=c["kv_lora_rank"],
        qk_nope_head_dim=c["qk_nope_head_dim"],
        qk_rope_head_dim=c["qk_rope_head_dim"],
        v_head_dim=c["v_head_dim"],
        n_dense_layers=c["first_k_dense_replace"],
        norm_topk_prob=c["norm_topk_prob"],
        rope_factor=float(rs["factor"]),
        rope_original_max=rs["original_max_position_embeddings"],
        rope_beta_fast=float(rs["beta_fast"]),
        rope_beta_slow=float(rs["beta_slow"]),
        rope_mscale_all_dim=rs["mscale_all_dim"])


def check_layout(cfg, c: dict) -> None:
    """Fail unless the port's parameter tree is this layout, path for path,
    shape and dtype."""
    from repro_torch.models import init_params
    meta = weights.flat_leaves(init_params(cfg, seed=0, device="meta"))
    port = [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in meta]
    ours = [(p, tuple(s), d) for p, s, d, _ in layout(c)]
    if port != ours:
        raise RuntimeError(f"the port's parameter tree of {c['name']} is "
                           f"not the benchmark's MLA layout:\n{port}\n{ours}")


def moe(c: dict) -> dict:
    """The MoE keys as ``_port.check_dropless`` reads them."""
    return {"moe": {"n_experts": c["n_routed_experts"],
                    "top_k": c["num_experts_per_tok"],
                    "capacity_factor": c["capacity_factor"]}}


# ----------------------------------------------------------------- FLOPs
def token_flops(c: dict) -> float:
    """FLOPs of one token through every layer, attention over positions
    aside. ``Wkv_b`` (R x H(nope + v)) counts once a token either way:
    decompressing the token's latent (prefill), or the query through
    W_UK and the head outputs through W_UV (decode)."""
    L, n_dense, D, H, R, dn, dr, dv = _dims(c)
    proj = 2 * D * H * (dn + dr) + 2 * D * (R + dr) \
        + 2 * R * H * (dn + dv) + 2 * H * dv * D
    E, Fe = c["n_routed_experts"], c["moe_intermediate_size"]
    moe_ffn = 2 * D * E + c["num_experts_per_tok"] * 3 * 2 * D * Fe \
        + 3 * 2 * D * c["n_shared_experts"] * Fe
    dense_ffn = 3 * 2 * D * c["intermediate_size"]
    return float(L * proj + n_dense * dense_ffn + (L - n_dense) * moe_ffn)


def head_flops(c: dict) -> float:
    return float(2 * c["hidden_size"] * c["vocab_size"])


def prefill_flops(c: dict, n: int) -> float:
    """A causal prefill of ``n`` prompt tokens, decompressed, whose last
    logits are used: a head's scores over ``nope + rope`` and sums over
    ``v_head_dim`` at each of the n(n+1)/2 attended positions."""
    L, _, _, H, _, dn, dr, dv = _dims(c)
    attn = L * 2 * H * (dn + dr + dv) * n * (n + 1) / 2
    return n * token_flops(c) + attn + head_flops(c)


def decode_flops(c: dict, n_tokens: int, attended: int) -> float:
    """``n_tokens`` decoded tokens attending ``attended`` positions in all,
    absorbed: a head's score and sum each over the latent at a position."""
    L, _, _, H, R, _, dr, _ = _dims(c)
    attn = L * 2 * H * (R + dr + R) * attended
    return n_tokens * (token_flops(c) + head_flops(c)) + attn

"""MLP blocks: dense (swiglu / relu2 / gelu) and mixture-of-experts.

Counterpart of ``repro.models.mlp``: the products run in the compute
dtype. The MoE path is the reference's sort-based grouped dispatch with a
capacity factor: tokens sorted by expert (a stable sort), packed into an
``(E, C, D)`` buffer whose overflow row ``E`` takes the tokens past an
expert's capacity and is dropped, the experts' products run as grouped
``bmm``s, and the results combined back with their router weights.

The pack and the combine depart from the reference's formulation, not
from its result. The reference scatter-adds each token into its slot
(``buf.at[row, col].add``) and each kept copy into its token
(``y.at[ftok].add``); on the card a scatter-add sums by atomics in no
fixed order, so two clean runs could differ in bf16 and flip a greedy
token. The kept ``(row, col)`` slots are unique, so the port writes them
(only the dropped overflow row takes several tokens, and it is cut); and
it inverts the sort and sums each token's ``K`` copies by one reduction
over ``K``, whose order is fixed.

Under ``shard_hints`` with an ambient mesh whose data axes divide the
batch, ``moe_apply`` dispatches per data group, as the reference's
expert-parallel path does (``_moe_apply_local``): each group of
``(B // g) * S`` tokens has its own capacity, so where a capacity drops
tokens the result differs from the global dispatch's. Otherwise it runs
the global dispatch. The reference's layout hints around the dispatch
change no value and have no counterpart here.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import telemetry
from repro_torch.configs.base import ModelConfig
from repro_torch.draws import Stream
from repro_torch.models.common import act_fn, dense_init, dtype_of
from repro_torch.sharding.mesh import ambient_mesh
from repro_torch.sharding.rules import _axis_size, data_axes


# ---------------------------------------------------------------- dense MLP
def mlp_init(draws: Stream, cfg: ModelConfig, lead: tuple = (),
             d_ff: int | None = None):
    """A dense MLP's weights, stacked on ``lead``: ``wi``, ``wo``, then
    ``wg`` under swiglu, drawn in that order."""
    D = cfg.d_model
    Fd = cfg.d_ff if d_ff is None else d_ff
    pdt = dtype_of(cfg.param_dtype)
    out_scale = 1.0 / math.sqrt(Fd * 2 * cfg.n_layers)
    p = {"wi": dense_init(draws, lead, D, Fd, pdt),
         "wo": dense_init(draws, lead, Fd, D, pdt, scale=out_scale)}
    if cfg.act == "swiglu":
        p["wg"] = dense_init(draws, lead, D, Fd, pdt)
    return p


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    h = xc @ p["wi"].to(cdt)
    if cfg.act == "swiglu":
        h = F.silu(h) * (xc @ p["wg"].to(cdt))
    else:
        h = act_fn(cfg.act)(h)
    return h @ p["wo"].to(cdt)


# ----------------------------------------------------------------- MoE MLP
def moe_init(draws: Stream, cfg: ModelConfig, lead: tuple = ()):
    """A MoE block's weights, stacked on ``lead``: the router (float32
    whatever the parameter dtype), the expert stacks ``wi``/``wg``
    ``(E, D, Fe)`` and ``wo`` ``(E, Fe, D)``, and the shared experts'
    dense MLP when ``n_shared``."""
    moe = cfg.moe
    D, E, Fe = cfg.d_model, moe.n_experts, moe.d_expert
    pdt = dtype_of(cfg.param_dtype)
    out_scale = 1.0 / math.sqrt(Fe * 2 * cfg.n_layers)
    p = {
        "router": dense_init(draws, lead, D, E, torch.float32, scale=0.02),
        "wi": dense_init(draws, lead + (E,), D, Fe, pdt),
        "wg": dense_init(draws, lead + (E,), D, Fe, pdt),
        "wo": dense_init(draws, lead + (E,), Fe, D, pdt, scale=out_scale),
    }
    if moe.n_shared:
        p["shared"] = mlp_init(draws, cfg, lead, d_ff=moe.n_shared * Fe)
    return p


def _capacity(T: int, moe) -> int:
    c = int(math.ceil(moe.top_k * T * moe.capacity_factor / moe.n_experts))
    return max(8, -(-c // 8) * 8)       # round up to a lane-friendly multiple


def _route(p, xt: torch.Tensor, cfg: ModelConfig):
    """(gates (T,E), top weights (T,K) renormalised, top experts (T,K),
    aux loss). The top-k is a stable descending sort, so ties go to the
    lower expert id, as ``jax.lax.top_k`` breaks them. A configuration
    with ``norm_topk_prob`` false (``MLAConfig``'s DeepSeek-V2) keeps the
    top weights as the softmax gives them."""
    moe = cfg.moe
    logits = xt.to(torch.float32) @ p["router"]              # (T, E)
    gates = torch.softmax(logits, dim=-1)
    topw, tope = torch.sort(gates, dim=-1, descending=True, stable=True)
    topw, tope = topw[:, :moe.top_k], tope[:, :moe.top_k]
    if getattr(cfg, "norm_topk_prob", True):
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    # load-balancing aux loss (Switch-style)
    density = F.one_hot(tope[:, 0], moe.n_experts).to(torch.float32).mean(0)
    aux = moe.n_experts * torch.sum(density * gates.mean(0))
    return gates, topw, tope, aux


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (y (B,S,D), aux_loss scalar float32)."""
    if cfg.shard_hints:
        m = ambient_mesh()
        if m is not None:
            dp = data_axes(m)
            if x.shape[0] % _axis_size(m, dp) == 0:
                return _moe_apply_local(p, x, cfg, m, dp)
    B, S, D = x.shape
    y, aux = _moe_dispatch_tokens(p, x.reshape(B * S, D), cfg)
    return y.reshape(B, S, D), aux


def _moe_apply_local(p, x: torch.Tensor, cfg: ModelConfig, mesh, dp
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group dispatch: the tokens reshape to ``(g, (B // g) * S, D)``
    with ``g`` the size of the mesh's data axes ``dp``; each group is
    dispatched on its own, with the capacity of its tokens; the aux loss
    is the mean over the groups."""
    B, S, D = x.shape
    g = _axis_size(mesh, dp)
    outs = [_moe_dispatch_tokens(p, xt, cfg)
            for xt in x.reshape(g, (B // g) * S, D)]
    y = torch.stack([y for y, _ in outs]).reshape(B, S, D)
    return y, torch.stack([aux for _, aux in outs]).mean()


def _moe_dispatch_tokens(p, xt: torch.Tensor, cfg: ModelConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based grouped dispatch over flat tokens xt: (T, D). Counts the
    routed token copies (``moe_routed``, T·K) and the expert slots computed
    for them (``moe_slots``, E·C), from shapes."""
    moe = cfg.moe
    T, D = xt.shape
    E, K = moe.n_experts, moe.top_k
    cdt = dtype_of(cfg.compute_dtype)
    with telemetry.inner("moe.route"):
        xt = xt.to(cdt)
        _, topw, tope, aux = _route(p, xt, cfg)

    # ---- sort-based grouped dispatch
    with telemetry.inner("moe.dispatch"):
        C = _capacity(T, moe)
        telemetry.count("moe_routed", T * K)
        telemetry.count("moe_slots", E * C)
        dev = xt.device
        fe = tope.reshape(-1)                                # (T*K,) experts
        fw = topw.reshape(-1)
        ftok = torch.arange(T * K, device=dev) // K          # source tokens
        order = torch.sort(fe, stable=True).indices          # group by expert
        fe_s, fw_s, ftok_s = fe[order], fw[order], ftok[order]
        # slot within expert = sorted rank - start offset of its group
        starts = torch.searchsorted(fe_s, torch.arange(E, device=dev))
        slot = torch.arange(T * K, device=dev) - starts[fe_s]
        keep = slot < C
        row = torch.where(keep, fe_s, E)                     # overflow row E
        col = torch.where(keep, slot, 0)

        # the kept (row, col) slots are unique: only the dropped overflow
        # row is written more than once
        buf = torch.zeros((E + 1, C, D), dtype=cdt, device=dev)
        buf.index_put_((row, col), xt[ftok_s])
        buf = buf[:E]                                        # (E, C, D)
    with telemetry.inner("moe.experts"):
        h = torch.bmm(buf, p["wi"].to(cdt))
        h = F.silu(h) * torch.bmm(buf, p["wg"].to(cdt))
        out = torch.bmm(h, p["wo"].to(cdt))                  # (E, C, D)
        shared = mlp_apply(p["shared"], xt, cfg) if moe.n_shared else None

    with telemetry.inner("moe.combine"):
        # the reference's gather clamps the overflow row to E - 1, whose
        # (finite or not) value its zero weight then multiplies
        gathered = out[row.clamp(max=E - 1), col] \
            * torch.where(keep, fw_s, 0.0)[:, None].to(cdt)
        # combine in a fixed order: back to (T, K) order, summed over K
        inv = torch.empty_like(order)
        inv[order] = torch.arange(T * K, device=dev)
        y = gathered[inv].reshape(T, K, D).sum(dim=1)
        if shared is not None:
            y = y + shared
    return y, aux.to(torch.float32)


def moe_apply_dense(p, x: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain MoE path: every expert on every token, mask-combined. Its
    products scale with ``n_experts``; it is the oracle of the grouped
    dispatch in tests."""
    moe = cfg.moe
    B, S, D = x.shape
    cdt = dtype_of(cfg.compute_dtype)
    xt = x.reshape(B * S, D).to(cdt)
    gates, topw, tope, aux = _route(p, xt, cfg)
    w_full = torch.zeros_like(gates).scatter(1, tope, topw)
    h = torch.einsum("td,edf->etf", xt, p["wi"].to(cdt))
    h = F.silu(h) * torch.einsum("td,edf->etf", xt, p["wg"].to(cdt))
    out = torch.einsum("etf,efd->etd", h, p["wo"].to(cdt))
    y = torch.einsum("etd,te->td", out, w_full.to(cdt))
    if moe.n_shared:
        y = y + mlp_apply(p["shared"], xt, cfg)
    return y.reshape(B, S, D), aux.to(torch.float32)

"""Step builders: the training step, the prefill step and the serve step.

Counterpart of ``repro.runtime.steps``. ``make_train_step`` is the
reference's value-and-grad plus AdamW: autograd over detached,
``requires_grad`` copies of the parameter leaves, gradient accumulation
over ``tcfg.microbatches`` as a Python loop that sums the gradients and
divides by their count (the reference's ``lax.scan``), the optional int8
gradient compression with error feedback, and the remat policy of
``loss_fn``. ``make_prefill_step`` is the full forward that also
materialises the cache, ``make_serve_step`` one greedy decode step against
it. The reference compiles each with ``jax.jit``; the port runs them
eagerly, and every step is functional: it returns new tensors and writes
into none of the state it was given.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import tree
from repro_torch.models import decode_step, forward, init_params, loss_fn
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.compress import compress_grads, ef_init


def init_train_state(seed: int, cfg: ModelConfig, tcfg: TrainConfig, *,
                     device=None) -> Dict[str, Any]:
    """``{"params", "opt"}`` (plus ``"ef"`` under ``grad_compress``) on
    ``device``, the card unless given. The parameters are
    ``init_params(cfg, seed=seed)``'s."""
    params = init_params(cfg, seed=seed, device=device)
    state = {"params": params, "opt": adamw_init(params, cfg)}
    if tcfg.grad_compress:
        state["ef"] = ef_init(params)
    return state


def _value_and_grad(params, batch, cfg: ModelConfig, remat: str):
    """(loss, grads) of ``loss_fn`` at ``params``, grads in the params'
    structure and dtypes."""
    flat, treedef = tree.flatten_with_path(params)
    leaves = [leaf.detach().requires_grad_(True) for _, leaf in flat]
    loss, _ = loss_fn(tree.unflatten(treedef, leaves), batch, cfg,
                      remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree.unflatten(treedef, list(grads))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    nmb = tcfg.microbatches

    # The reference pins the gradients' layout to the parameters'
    # shardings here (``_constrain_like_params``); on one device there is
    # no layout to pin, so the port has no counterpart.

    def train_step(state, batch):
        params = state["params"]
        if nmb == 1:
            loss, grads = _value_and_grad(params, batch, cfg, tcfg.remat)
        else:
            mbs = {k: x.reshape((nmb, x.shape[0] // nmb) + x.shape[1:])
                   for k, x in batch.items()}
            flat, treedef = tree.flatten_with_path(params)
            gsum = [torch.zeros_like(leaf) for _, leaf in flat]
            lsum = torch.zeros((), dtype=torch.float32,
                               device=flat[0][1].device)
            for i in range(nmb):
                loss_i, g = _value_and_grad(
                    params, {k: x[i] for k, x in mbs.items()}, cfg,
                    tcfg.remat)
                gsum = [a + b for a, b in zip(gsum, tree.leaves(g))]
                lsum = lsum + loss_i
            grads = tree.unflatten(treedef, [g / nmb for g in gsum])
            loss = lsum / nmb

        new_state = {}
        if tcfg.grad_compress:
            grads, new_ef, _ = compress_grads(grads, state["ef"])
            new_state["ef"] = new_ef
        new_params, new_opt, om = adamw_update(params, grads, state["opt"],
                                               tcfg)
        new_state.update({"params": new_params, "opt": new_opt})
        return new_state, {"loss": loss, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch):
        logits, _, cache = forward(params, batch, cfg, return_cache=True)
        # return only the last position's logits (the serving handoff)
        return logits[:, -1], cache
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(params, cache, token: torch.Tensor, pos: int):
        logits, cache = decode_step(params, token, pos, cache, cfg)
        return cache, torch.argmax(logits, dim=-1), pos + 1
    return serve_step

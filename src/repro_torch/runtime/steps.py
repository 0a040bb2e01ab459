"""Step builders of the serving path.

Counterpart of ``repro.runtime.steps``'s serving half:
``make_prefill_step`` is the full forward that also materialises the
cache, ``make_serve_step`` one greedy decode step against it. The
reference compiles each with ``jax.jit``; the port runs them eagerly. The
training step waits for ROADMAP.md, queue 1, item 7b.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, forward


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

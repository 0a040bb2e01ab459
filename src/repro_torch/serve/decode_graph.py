"""The latent decode step as one CUDA graph replay.

``OnlineEngine`` runs every decode step of a latent (``MLAConfig``) cache
through a ``DecodeGraph``. The step has one shape for the engine's life
(every slot, every page of the table), so on the card the engine's first
step runs eagerly and warms the libraries up, the next captures the eager
step's ops, unchanged (``engine.latent_decode_step``), over static
buffers, and every later step replays them: the host enqueues one graph
instead of the step's thousand-odd launches. On the CPU the step runs
eagerly.

The graph reads the parameters and writes the latents where the captured
step did: in the leaves of the params domain's payload and in the cache's
latent pool, by address. So what a replay computes with is what the HRM
verbs check and repair; a leaf written in place is read as written. The
key is those addresses (every leaf's path, address, shape, stride and
dtype, and the pool's storage) with the table's shape: a verb that hands
the engine a new leaf or pool (a patrol scrub rebuilds its SEC-DED
leaves, a correction, a reload, a crash reset) makes a new key, and the
step captures again, into the previous capture's memory pool, before it
replays. The page table, tokens and positions are copied into static
buffers on every replay; the next tokens and the finiteness flag come
back as clones.

Counters: a replay adds the counts its capture made (``moe_routed``,
``moe_slots``), ``decode_replays`` one a replayed step and
``decode_captures`` one a capture.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import telemetry
from repro_torch.models import query_graph


def key_of(params, pool: torch.Tensor, table: torch.Tensor) -> tuple:
    """What a captured step reads and writes, by address (docstring)."""
    return (pool.untyped_storage().data_ptr(), tuple(pool.shape),
            tuple(table.shape),
            tuple((path, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                  for path, t in query_graph.leaves(params)))


class DecodeGraph:
    """One engine's latent decode step, captured on its second step and
    again after a new key, replayed otherwise (module docstring)."""

    def __init__(self, step: Callable):
        self._step = step             # the eager step: engine.latent_decode_step
        self._warm = False
        self._key = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._inputs: Tuple[torch.Tensor, ...] = ()
        self._out: Tuple[torch.Tensor, torch.Tensor] = ()
        self._counts: Dict[str, int] = {}

    def __call__(self, params, pool: torch.Tensor, table: torch.Tensor,
                 tokens: torch.Tensor, pos: torch.Tensor, cfg,
                 page_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        if pool.device.type != "cuda" or not self._warm:   # warm-up: eager
            self._warm = pool.device.type == "cuda"
            return self._step(params, pool, table, tokens, pos, cfg,
                              page_size)
        key = key_of(params, pool, table)
        if key != self._key:
            self._capture(params, pool, table, tokens, pos, cfg, page_size)
            self._key = key
        for static, new in zip(self._inputs, (table, tokens, pos)):
            static.copy_(new)
        query_graph.replay(self._graph, self._counts)
        telemetry.count("decode_replays", 1)
        return tuple(t.clone() for t in self._out)

    def _capture(self, params, pool, table, tokens, pos, cfg,
                 page_size) -> None:
        # a new capture allocates from the previous one's memory pool (that
        # graph is never replayed again): a capture in ~50 steps would
        # otherwise reserve a new pool each time
        prev = self._graph
        self._inputs = (table.clone(), tokens.clone(), pos.clone())
        self._graph, self._out, self._counts = query_graph.capture(
            self._step, params, pool, *self._inputs, cfg, page_size,
            pool=prev.pool() if prev is not None else None)
        telemetry.count("decode_captures", 1)

"""The engine's decode step as one CUDA graph replay.

``OnlineEngine`` runs every decode step through one ``DecodeGraph``
around ``models.transformer.paged_decode_step``, which takes the cache's
named pools (``k`` and ``v``, or an ``MLAConfig``'s ``latent``) as one
dict. The step has one shape for the engine's life (every slot, every
page of the table), so on the card the engine's first step runs eagerly
and warms the libraries up, the next captures the eager step's ops,
unchanged, over static buffers, and every later step replays them: the
host enqueues one graph instead of the step's thousand-odd launches.
Where a capture cannot run (pools off the card, as in the CPU tests; a
leaf that is a tensor subclass such as a DTensor; an ambient mesh) the
step runs eagerly.

The graph reads the parameters and writes the new K/V (or latents) where
the captured step did: in the leaves of the params domain's payload and
in the cache's pools, by address. So what a replay computes with is what
the HRM verbs check and repair; a leaf or a pool written in place is read
as written. The key is those addresses (every leaf's path, address,
shape, stride and dtype, and every pool's name, storage and shape) with
the table's shape: a verb that hands the engine a new leaf or pool (a
patrol scrub rebuilds its SEC-DED leaves; a KV correction, a peer copy
or a crash reset adopts new pools) makes a new key, and the step
captures again, into the previous capture's memory pool, before it
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
from repro_torch.sharding.mesh import ambient_mesh


def key_of(params, pools: Dict[str, torch.Tensor],
           table: torch.Tensor) -> tuple:
    """What a captured step reads and writes, by address (docstring)."""
    return (tuple((name, p.untyped_storage().data_ptr(), tuple(p.shape))
                  for name, p in pools.items()),
            tuple(table.shape),
            tuple((path, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                  for path, t in query_graph.leaves(params)))


def _captures(params, pools: Dict[str, torch.Tensor]) -> bool:
    """Whether a step over these inputs can be captured: every pool on the
    card, every leaf a plain tensor, no ambient mesh."""
    return (all(p.device.type == "cuda" for p in pools.values())
            and ambient_mesh() is None
            and all(type(t) is torch.Tensor
                    for _, t in query_graph.leaves(params)))


class DecodeGraph:
    """One engine's decode step, captured on its second step and again
    after a new key, replayed otherwise (module docstring)."""

    def __init__(self, step: Callable):
        self._step = step      # the eager step over (params, pools, ...)
        self._warm = False
        self._key = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._stream: Optional[torch.cuda.Stream] = None   # every capture's
        self._inputs: Tuple[torch.Tensor, ...] = ()
        self._out: Tuple[torch.Tensor, torch.Tensor] = ()
        self._counts: Dict[str, int] = {}

    def __call__(self, params, pools: Dict[str, torch.Tensor],
                 table: torch.Tensor, tokens: torch.Tensor,
                 pos: torch.Tensor, cfg, page_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``step(params, pools, table, tokens, pos, cfg, page_size)``'s
        (next tokens, ok), replayed where it can be."""
        args = (params, pools, table, tokens, pos, cfg, page_size)
        if not _captures(params, pools):
            return self._step(*args)
        if not self._warm:                          # warm-up: eager
            self._warm = True
            return self._step(*args)
        key = key_of(params, pools, table)
        if key != self._key:
            self._capture(params, pools, table, tokens, pos, cfg, page_size)
            self._key = key
        for static, new in zip(self._inputs, (table, tokens, pos)):
            static.copy_(new)
        query_graph.replay(self._graph, self._counts)
        telemetry.count("decode_replays", 1)
        return tuple(t.clone() for t in self._out)

    def _capture(self, params, pools, table, tokens, pos, cfg,
                 page_size) -> None:
        # a new capture allocates from the previous one's memory pool (that
        # graph is never replayed again), on the previous one's stream: a
        # capture in ~50 steps would otherwise reserve new memory each time
        prev = self._graph
        if self._stream is None:
            self._stream = torch.cuda.Stream(table.device)
        self._inputs = (table.clone(), tokens.clone(), pos.clone())
        self._graph, self._out, self._counts = query_graph.capture(
            self._step, params, pools, *self._inputs, cfg, page_size,
            stream=self._stream,
            pool=prev.pool() if prev is not None else None)
        telemetry.count("decode_captures", 1)

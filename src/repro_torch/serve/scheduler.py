"""Continuous-batching scheduler: slot bookkeeping for the online plane.

Counterpart of ``repro.serve.scheduler``, copied.

The decode batch is a fixed array of ``slots``; each iteration the engine
(1) admits up to ``max_prefills_per_step`` queued requests into free
slots (prefill runs as its own (shorter) call per request, so one long
prompt delays the decode batch by one prefill, never stalls it for a
whole generation), and (2) runs one fused decode step over every slot.
A slot completes when its request has emitted ``max_new`` tokens; its
pages return to the free list and the slot admits the next request.

The scheduler is pure host bookkeeping (which request sits where, per-slot
position and emitted tokens); the engine owns all device compute.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.serve.paged_kv import PagedKVCache
from repro_torch.serve.traffic import Request


@dataclass
class SlotState:
    req: Request
    pos: int                      # next KV position to write (decode)
    t_admitted: float
    t_first_token: float
    tokens: List[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.req.max_new


@dataclass
class CompletedRequest:
    req: Request
    tokens: List[int]
    t_admitted: float
    t_first_token: float
    t_done: float


class ContinuousBatchingScheduler:
    def __init__(self, cache: PagedKVCache,
                 max_prefills_per_step: int = 2):
        self.cache = cache
        self.slots: List[Optional[SlotState]] = [None] * cache.slots
        self.max_prefills_per_step = max_prefills_per_step
        self.completed: List[CompletedRequest] = []
        self.peak_active = 0

    # ----------------------------------------------------------- queries
    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def can_admit(self, req: Request) -> bool:
        return (self.free_slot() is not None
                and self.cache.can_admit(req.footprint_tokens()))

    # --------------------------------------------------------- admission
    def admit(self, req: Request, first_token: int, now: float) -> int:
        """Bind an (already prefilled) request to a slot. The engine has
        run the prefill and produced the first generated token; pages for
        the full footprint were reserved via ``cache.alloc``."""
        slot = self.free_slot()
        assert slot is not None, "admit() without a free slot"
        st = SlotState(req=req, pos=req.prompt_len, t_admitted=now,
                       t_first_token=now, tokens=[first_token])
        self.slots[slot] = st
        self.peak_active = max(self.peak_active, self.n_active)
        if st.done:                      # max_new == 1: done at prefill
            self._complete(slot, now)
        return slot

    # ------------------------------------------------------ decode batch
    def batch_inputs(self) -> tuple:
        """(tokens, pos) int32 arrays over every slot; inactive slots get
        token 0 at pos 0 and write into the null page (their outputs are
        discarded)."""
        n = len(self.slots)
        tokens = np.zeros(n, np.int32)
        pos = np.zeros(n, np.int32)
        for i, s in enumerate(self.slots):
            if s is not None:
                tokens[i] = s.tokens[-1]
                pos[i] = s.pos
        return tokens, pos

    def record_step(self, next_tokens: np.ndarray, now: float) -> List[int]:
        """Advance every active slot with its decoded token; returns the
        slots completed this step."""
        done = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            s.pos += 1
            if not s.done:
                s.tokens.append(int(next_tokens[i]))
            if s.done:
                self._complete(i, now)
                done.append(i)
        return done

    # -------------------------------------------------------- completion
    def _complete(self, slot: int, now: float) -> None:
        s = self.slots[slot]
        self.cache.release(slot)
        self.slots[slot] = None
        self.completed.append(CompletedRequest(
            req=s.req, tokens=list(s.tokens), t_admitted=s.t_admitted,
            t_first_token=s.t_first_token, t_done=now))

    def evict_all(self) -> List[Request]:
        """Crash path: drop every in-flight request (their pages and
        slots are reclaimed) and hand the requests back for re-queueing."""
        dropped = []
        for i, s in enumerate(self.slots):
            if s is not None:
                self.cache.release(i)
                self.slots[i] = None
                dropped.append(s.req)
        return dropped

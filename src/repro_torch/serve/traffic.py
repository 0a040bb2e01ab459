"""Synthetic request traffic: the arrival process the online plane serves.

Counterpart of ``repro.serve.traffic``, copied: numpy only, so a trace
drawn from one seed is the same request for request in both packages.

A trace is a list of timestamped ``Request``s. Arrivals follow either a
plain Poisson process or a two-state Markov-modulated Poisson process
("bursty": a calm state at the configured rate and a burst state at
``burst_mult`` times it, the on/off flash-crowd shape of production
serving traffic). Prompt and output lengths are drawn from small discrete
distributions so the engine compiles one prefill program per length
bucket instead of one per request.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Request:
    """One timestamped generation request."""
    rid: int
    arrival: float               # seconds since trace start
    prompt: np.ndarray           # (prompt_len,) int32 token ids
    max_new: int                 # tokens to generate

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def footprint_tokens(self) -> int:
        """KV positions this request needs for its whole lifetime."""
        return self.prompt_len + self.max_new


@dataclass(frozen=True)
class TrafficConfig:
    n_requests: int = 50
    rate: float = 8.0                    # mean requests per second
    process: str = "poisson"             # "poisson" | "bursty"
    burst_mult: float = 8.0              # burst-state rate multiplier
    p_enter_burst: float = 0.05          # per-arrival state transitions
    p_exit_burst: float = 0.30
    prompt_len_choices: Tuple[int, ...] = (8, 16)
    prompt_len_weights: Optional[Tuple[float, ...]] = None
    max_new_choices: Tuple[int, ...] = (4, 8)
    max_new_weights: Optional[Tuple[float, ...]] = None
    seed: int = 0

    @property
    def max_prompt_len(self) -> int:
        return max(self.prompt_len_choices)

    @property
    def max_new_cap(self) -> int:
        return max(self.max_new_choices)


def _norm(weights: Optional[Sequence[float]], n: int) -> np.ndarray:
    if weights is None:
        return np.full(n, 1.0 / n)
    w = np.asarray(weights, dtype=np.float64)
    return w / w.sum()


def generate_trace(tc: TrafficConfig, vocab_size: int) -> List[Request]:
    """Sample a full request trace (sorted by arrival time)."""
    rng = np.random.default_rng(tc.seed)
    p_len = _norm(tc.prompt_len_weights, len(tc.prompt_len_choices))
    p_new = _norm(tc.max_new_weights, len(tc.max_new_choices))
    out: List[Request] = []
    t = 0.0
    bursting = False
    for rid in range(tc.n_requests):
        rate = tc.rate
        if tc.process == "bursty":
            if bursting:
                rate = tc.rate * tc.burst_mult
                if rng.random() < tc.p_exit_burst:
                    bursting = False
            elif rng.random() < tc.p_enter_burst:
                bursting = True
        elif tc.process != "poisson":
            raise ValueError(f"unknown arrival process {tc.process!r}")
        t += float(rng.exponential(1.0 / max(rate, 1e-9)))
        plen = int(rng.choice(tc.prompt_len_choices, p=p_len))
        mnew = int(rng.choice(tc.max_new_choices, p=p_new))
        prompt = rng.integers(0, vocab_size, size=plen, dtype=np.int32)
        out.append(Request(rid=rid, arrival=t, prompt=prompt, max_new=mnew))
    return out

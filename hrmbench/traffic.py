"""Traffic of a cell: the requests or queries a run sends, from its seed.

``Request``, ``TrafficConfig`` and ``generate_trace`` are a copy of the
port's ``repro_torch.serve.traffic`` (numpy only): a plain Poisson process
or a two-state Markov-modulated Poisson process ("bursty": a calm state at
``rate`` and a burst state at ``burst_mult`` times it).

``cell_requests`` reads a mix file (``traffic/<mix>.json``) and gives every
seed the same work: the arrival times come from the mix's own
``arrival_seed`` (so every seed sees the same bursts), the prompt and
output lengths are the mix's exact shares of the requests, shuffled by the
run's seed, and the prompt tokens are drawn from the run's seed.
``lm_query`` is the port's web-search LM query (``data/synthetic.py``'s
``lm_batch`` arithmetic): a Zipf body with copy spans.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from hrmbench.seeds import derive

TRAFFIC_STREAM = 2
QUERY_STREAM = 3


# --------------------------------------------------- copied from the port
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


# ------------------------------------------------------ the benchmark's
def arrivals(mix: dict, seconds: float) -> np.ndarray:
    """The mix's arrival times inside ``[0, seconds)``: all at 0 for a
    ``batch`` of ``n_requests``, else the copied generator's, drawn from
    the mix's ``arrival_seed``."""
    if mix["process"] == "batch":
        return np.zeros(int(mix["n_requests"]))
    n = int(mix["rate"] * seconds * 2) + 16
    while True:
        tc = TrafficConfig(
            n_requests=n, rate=mix["rate"], process=mix["process"],
            burst_mult=mix.get("burst_mult", 8.0),
            p_enter_burst=mix.get("p_enter_burst", 0.05),
            p_exit_burst=mix.get("p_exit_burst", 0.30),
            prompt_len_choices=(1,), max_new_choices=(1,),
            seed=mix["arrival_seed"])
        t = np.array([r.arrival for r in generate_trace(tc, 2)])
        if t[-1] >= seconds:
            return t[t < seconds]
        n *= 2


def exact_shares(n: int, choices: Sequence[int], weights: Sequence[float]
                 ) -> np.ndarray:
    """``n`` values with each choice's share of ``weights`` (largest
    remainders first, ties to the earlier choice), in choice order."""
    w = _norm(weights, len(choices))
    raw = w * n
    counts = np.floor(raw).astype(np.int64)
    for i in np.argsort(-(raw - counts), kind="stable")[:n - counts.sum()]:
        counts[i] += 1
    return np.repeat(np.asarray(choices, np.int64), counts)


def cell_requests(mix: dict, seed: int, vocab: int, seconds: float
                  ) -> List[Request]:
    """The run's requests, sorted by arrival."""
    t = arrivals(mix, seconds)
    n = len(t)
    rng = np.random.default_rng(derive(seed, TRAFFIC_STREAM))
    plens = rng.permutation(exact_shares(
        n, mix["prompt_len_choices"], mix["prompt_len_weights"]))
    news = rng.permutation(exact_shares(
        n, mix["max_new_choices"], mix["max_new_weights"]))
    return [Request(rid=i, arrival=float(t[i]),
                    prompt=rng.integers(0, vocab, size=int(plens[i]),
                                        dtype=np.int32),
                    max_new=int(news[i])) for i in range(n)]


def lm_query(vocab: int, batch: int, seq: int, seed: int) -> np.ndarray:
    """(batch, seq) int64 query tokens: a Zipf body with copy spans."""
    rng = np.random.default_rng(derive(seed, QUERY_STREAM))
    base = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64) \
        % (vocab - 1) + 1
    period = 17
    idx = np.arange(seq + 1)
    copy_from = np.maximum(idx - period, 0)
    mask = (idx % period) < (period // 2)
    return np.where(mask[None, :], base[:, copy_from], base)[:, :-1]

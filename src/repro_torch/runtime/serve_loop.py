"""Batched serving loop (prefill + decode) with HRM on the params: the
paper's Memcached/WebSearch-style always-on workload.

Counterpart of ``repro.runtime.serve_loop``. The loop owns one
``MemoryDomain`` over the params root, built once: the per-token strikes
and the scrubs reuse its leaf table and byte weights. The strikes draw the
reference's numpy stream (``np.random.default_rng(seed + 1)``: one uniform
a token for the strike decision, then ``MemoryDomain.inject``'s draws), so
both packages strike the same words from the same seed. Decoding reads
the domain's payload, struck and scrubbed as it is; detected words are
counted, not reloaded, as in the reference. The prefill's batch holds
tokens only, so the audio and vision frontends fail there on the missing
frames or patches (``KeyError``), as the reference's do; a VLM is served
by composing ``make_prefill_step`` on tokens and patches with
``make_serve_step``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import HRMPolicy, MemoryDomain
from repro_torch.models import init_cache
from repro_torch.runtime.steps import make_prefill_step, make_serve_step


@dataclass
class ServeReport:
    tokens_emitted: int = 0
    queries: int = 0
    scrub_corrected: int = 0
    scrub_detected: int = 0
    injected: int = 0
    sidecar_overhead: float = 0.0


def _with_headroom(cache, full):
    """The prefill's cache in the decode cache's shapes: a KV leaf sized to
    the prompt is written into the leading corner of ``full``'s (which
    has head-room for the new tokens); a leaf with no sequence axis (a
    recurrent state) has ``full``'s shape already and is taken as it is,
    in ``full``'s dtype."""
    for name, dst in full.items():
        src = cache[name]
        if src.shape == dst.shape:
            full[name] = src.to(dst.dtype)
        else:
            dst[tuple(slice(0, n) for n in src.shape)] = src
    return full


def serve_batch(cfg: ModelConfig, params, prompts: torch.Tensor,
                max_new_tokens: int, *, policy: Optional[HRMPolicy] = None,
                error_rate_per_token: float = 0.0, seed: int = 0):
    """prompts: (B, S0) int -> (generated (B, max_new_tokens), report).

    Runs on the device of ``prompts`` and ``params``."""
    B, S0 = prompts.shape
    report = ServeReport()
    prefill = make_prefill_step(cfg)
    serve = make_serve_step(cfg)

    logits_last, cache = prefill(params, {"tokens": prompts})
    cache = _with_headroom(cache, init_cache(cfg, B, S0 + max_new_tokens,
                                             device=prompts.device))

    # leaf table + sidecars built once: nothing re-indexes in the token
    # loop. With no policy there is no domain (and no sidecar overhead to
    # report); injection alone still needs the leaf table, so an
    # unprotected (sidecar-free) domain is built only in that case.
    domain = None
    if policy is not None:
        domain = MemoryDomain.protect(params, policy)
        report.sidecar_overhead = domain.stats().overhead
    elif error_rate_per_token > 0:
        domain = MemoryDomain.protect(params, HRMPolicy("unprotected", {}))
    rng = np.random.default_rng(seed + 1)

    token = torch.argmax(logits_last, dim=-1)
    pos = S0
    out: List[torch.Tensor] = []
    for t in range(max_new_tokens):
        if error_rate_per_token > 0 and rng.random() < error_rate_per_token:
            domain, ev = domain.inject(rng, 1)
            report.injected += len(ev)
        if policy is not None and t > 0 and \
                t % max(policy.scrub_interval, 1) == 0:
            domain, rep = domain.scrub()
            c, u = rep.totals()
            report.scrub_corrected += c
            report.scrub_detected += u
        out.append(token)
        cache, token, pos = serve(
            domain.payload if domain is not None else params, cache, token,
            pos)
        report.tokens_emitted += B
    report.queries += B
    return torch.stack(out, dim=1), report

"""Driver ``online_mla``: the ``online`` driver's open loop for a
DeepSeek-V2 configuration (multi-head latent attention): requests due at
their arrivals, served by the port's ``OnlineEngine`` over its latent
page pool until every request due in the window has finished; the tails
of time per output token on the serving clock.

What serves and what is checked is ``_serving``'s, by import: the serving
clock and the traced spans (``BenchEngine``, whose hooks ``check_hooks``
holds to the port's), the warm-up, the sample of served tokens, the
strikes after the window and their expected responses, and the gaps of
the served tokens in the reference's logits. This file carries what
differs: the configuration, weights and layout check (``hrmbench/mla.py``),
the model FLOPs of the traced stretch in latent form, the reference
(``reference/mla.py``), and the schedule of the requests: their arrivals
and their prompt and answer lengths come from the mix's ``arrival_seed``
(``traffic.cell_requests`` under that seed), so that every seed serves
the same work, and the run's seed draws the prompts' tokens. With
4k-16k prompts prefilled whole, a request's time per token is set by the
long prefills that land inside its life; lengths shuffled by the run's
seed moved the 95th percentile by 16 % from seed to seed. A port
without latent attention fails at import.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

try:
    from repro_torch.configs.base import MLAConfig  # noqa: F401
except ImportError as e:               # a port from before latent attention
    raise ImportError(
        "this port has no multi-head latent attention "
        "(repro_torch.configs.base.MLAConfig): it cannot serve a DeepSeek-V2 "
        "configuration") from e

from hrmbench import mla, traffic, weights  # noqa: E402
from hrmbench.drivers import _port, _serving  # noqa: E402
from hrmbench.profile import Window, sync  # noqa: E402
from hrmbench.reference import judge  # noqa: E402
from hrmbench.reference import mla as ref_mla  # noqa: E402
from hrmbench.reference import model as ref_model  # noqa: E402
from hrmbench.seeds import derive  # noqa: E402
from repro_torch.serve.engine import OnlineEngine  # noqa: E402
from repro_torch.serve.metrics import SLOCounters  # noqa: E402


def requests(mix: dict, seed: int, vocab: int, seconds: float):
    """The run's requests: ``traffic.cell_requests``'s schedule under the
    mix's ``arrival_seed``, with prompt tokens drawn from ``seed``."""
    rng = np.random.default_rng(derive(seed, traffic.TRAFFIC_STREAM))
    return [dataclasses.replace(r, prompt=rng.integers(
                0, vocab, size=r.prompt_len, dtype=np.int32))
            for r in traffic.cell_requests(mix, mix["arrival_seed"], vocab,
                                           seconds)]


class MLABenchEngine(_serving.BenchEngine):
    """``BenchEngine`` whose traced prefills and decode steps add the
    latent-attention model FLOPs (``mla.prefill_flops``,
    ``mla.decode_flops``) to the profiled stretch."""

    def _run_prefill(self, req, pages):
        if not self.traced:
            return OnlineEngine._run_prefill(self, req, pages)
        out, ms = self._span("prefill", super(
            _serving.BenchEngine, self)._run_prefill, req, pages)
        self.spans["prefill"][-1] = (req.prompt_len, ms)
        self.prefill_ms[req.rid] = ms
        if self.window is not None and self.window.active:
            self.profile_flops += mla.prefill_flops(self.c, req.prompt_len)
        return out

    def _run_decode(self):
        if not self.traced:
            return OnlineEngine._run_decode(self)
        active = [s for s in self.sched.slots if s is not None]
        out, _ = self._span("decode", super(
            _serving.BenchEngine, self)._run_decode)
        self.decoded += len(active)
        self.decode_steps += 1
        if self.window is not None and self.window.active:
            self.profile_flops += mla.decode_flops(
                self.c, len(active), sum(s.pos + 1 for s in active))
        return out


def run(ctx) -> dict:
    """One run of the cell: ``_serving.run(ctx, drain=True)`` with the
    latent-attention configuration, weights and reference."""
    c, cell, mix, dev = ctx.config, ctx.cell, ctx.mix, ctx.device
    rec: dict = {"build_s": _port.build_kernels(dev)}
    cfg = mla.port_config(c)
    mla.check_layout(cfg, c)
    page = cell["page_size"]
    max_prompt = max(mix["prompt_len_choices"])
    _port.check_dropless(mla.moe(c), max(-(-max_prompt // page) * page,
                                         cell["slots"]))
    params = mla.make(c, ctx.seed, dev)
    reqs = requests(mix, ctx.seed, c["vocab_size"], ctx.seconds)
    from repro_torch.core import DESIGN_POINTS, Tier
    eng = MLABenchEngine(
        cfg, params, c=c, traced=ctx.trace, slots=cell["slots"],
        page_size=page, max_prompt_len=max_prompt,
        max_new_cap=max(mix["max_new_choices"]),
        policy=DESIGN_POINTS[cell["policy"]](),
        kv_tier=Tier(cell["kv_tier"]),
        max_prefills_per_step=cell["prefills_per_step"],
        seed=derive(ctx.seed, _serving.ENGINE_STREAM))
    del params
    rec["kv_pool_bytes"] = eng.cache.pool_bytes
    rec["param_bytes"] = eng.param_domain.stats().payload_bytes
    _serving._warm(eng, mix, c["vocab_size"])
    if ctx.trace:
        eng.window, eng.launches = Window(dev), _serving.LaunchRows()
        mid = ctx.seconds / 2
        eng.profile_from = mid - cell["trace_s"] / 2
        eng.profile_to = mid + cell["trace_s"] / 2
    rec["setup_s"] = time.perf_counter() - ctx.t0

    eng.start_clock()
    eng.run(reqs)
    sync()
    if eng.window is not None and eng.window.active:
        eng.launches.stop()
        eng.window.stop()
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated() \
        if dev.type == "cuda" else 0

    done = list(eng.sched.completed)
    counters = eng.counters or SLOCounters()
    eng.traced = False          # the verbs below are not the window's
    rec["attempted"] = len(reqs)
    rec["failed"] = len(reqs) - len(done)
    rec["ttft_ms"] = [(d.t_first_token - d.req.arrival) * 1e3 for d in done]
    rec["tpot_ms"] = [(d.t_done - d.t_first_token) * 1e3
                      / (len(d.tokens) - 1)
                      for d in done if len(d.tokens) > 1]
    rec["requests_done"] = len(done)
    rec["requests"] = [(d.req.arrival, d.t_admitted, d.t_first_token,
                        d.t_done, len(d.tokens)) for d in done]
    if ctx.trace:
        rec["spans"] = eng.spans
        rec["queue_wait_ms"] = [(d.t_admitted - d.req.arrival) * 1e3
                                - eng.prefill_ms[d.req.rid] for d in done]
        rec["decoded"], rec["decode_steps"] = eng.decoded, eng.decode_steps
        w = eng.window
        if w.window_s is not None:
            rec["profile"] = {
                "busy_s": w.busy_s, "window_s": w.window_s,
                "kernels": w.kernels, "top_ops": w.top_ops,
                "idle_by_host": w.idle_by_host,
                "flops": eng.profile_flops, "rows": eng.launches.rows}

    # ------------------------------------------ correctness, window closed
    hrm_events = sum(int(getattr(counters, k)) for k in (
        "kv_corrected", "kv_detected", "params_corrected", "params_detected",
        "recovery_events", "peer_recovery_events", "crash_events"))
    strike_diff, rec["strikes"] = _serving._strike_check(eng, cell, ctx.seed)
    fresh = mla.make(c, ctx.seed, dev)
    changed = sum(int((_serving._bits(a) != _serving._bits(b)).sum())
                  for (_, a), (_, b) in zip(
                      weights.flat_leaves(eng.param_domain.payload),
                      weights.flat_leaves(fresh)))
    sample = [(d.req.prompt, list(d.tokens))
              for d in _serving._sample(done, ctx.seed, cell["sample_tokens"])]
    del eng, done
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    prog, ctrl = [], []
    for prompt, toks in sample:
        seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]),
                              dtype=torch.long, device=dev)
        out = torch.as_tensor(toks, dtype=torch.long, device=dev)
        ref = ref_mla.logits(fresh, c, seq, last=len(toks))
        prog.append(judge.gaps(ref, out))
        if ctx.control:
            low = ref_mla.logits(fresh, c, seq, last=len(toks),
                                 prec=ref_model.Precision(fp8=True))
            ctrl.append(judge.control_gaps(ref, low))
            del low
        del ref
    rec["reference_s"] = time.perf_counter() - t
    judged = judge.summary(torch.cat(prog)) if prog else \
        {"mean": float("inf"), "max": float("inf"), "not_first": 1.0, "n": 0}
    rec["judged"] = judged
    if ctx.control:
        rec["control"] = judge.summary(torch.cat(ctrl))
    lim = cell["limits"]
    rec["checks"] = [
        ("served_gap_mean", judged["mean"], lim["served_gap_mean"], "max"),
        ("hrm_events", hrm_events, 0, "max"),
        ("strike_responses_differing", strike_diff, 0, "max"),
        ("params_bits_changed", changed, 0, "max"),
        ("requests_missing", rec["failed"], 0, "max"),
        ("served_tokens_judged", judged["n"], lim["served_tokens_judged"],
         "min"),
    ]
    return rec

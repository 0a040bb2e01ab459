"""Serving cells: the port's ``OnlineEngine`` on the benchmark's clock.

``BenchEngine`` subclasses ``repro_torch.serve.engine.OnlineEngine``. Its
``_advance`` moves the serving clock on by all the wall time spent since
the previous advance: the KV check and refresh, the params scrub and its
reloads, routing, admission, prefill and decode (the engine's own
fetches wait for the device). The time inside a strike (``_inject_one``)
and inside the profiler's own start and stop is left out. The engine's
jump over idle time to the next arrival stays. The hooks it overrides are
checked by name and signature, and a missing one fails the run.

Once the window has closed, the cell's strikes are planted in the same
engine (``reference/strikes.py``: the benchmark's own bit flips in the
parameters and the KV pages, every tier the design point uses) and the
engine's KV check and params scrub must answer each as the design point
says: correct it, detect it and reload the leaf, or detect it.

In a traced run the engine's verbs are also timed, each between two
device synchronisations and under a ``record_function`` label, and a
stretch in the middle of the window runs under the profiler.
"""
from __future__ import annotations

import gc
import inspect
import math
import time
from typing import Dict

import numpy as np
import torch

from hrmbench import flops, traffic, weights
from hrmbench.drivers import _port
from hrmbench.profile import Window, sync
from hrmbench.reference import judge
from hrmbench.reference import model as ref_model
from hrmbench.reference import strikes
from hrmbench.seeds import derive
from repro_torch.kernels import _build
from repro_torch.serve.engine import OnlineEngine
from repro_torch.serve.metrics import SLOCounters

ENGINE_STREAM, SAMPLE_STREAM, STRIKE_STREAM = 4, 5, 6
WARM_SEED = 7

# hook -> its parameters, as the port defines them
HOOKS = {
    "_advance": ("self", "now", "model_cost", "t_wall"),
    "_inject_one": ("self", "counters"),
    "_run_prefill": ("self", "req", "pages"),
    "_run_decode": ("self",),
    "_scrub_kv": ("self", "counters"),
    "_refresh_kv": ("self",),
    "_scrub_params": ("self", "counters"),
}


def check_hooks() -> None:
    for name, want in HOOKS.items():
        fn = getattr(OnlineEngine, name, None)
        got = tuple(inspect.signature(fn).parameters) if fn else None
        if got != want:
            raise RuntimeError(f"OnlineEngine.{name}{got} is not the hook "
                               f"{want} that the serving clock overrides")


class WindowClosed(Exception):
    """The serving clock passed the end of a batch cell's window."""


class LaunchRows:
    """Rows of packed words each kernel of ``flops.KERNEL_BYTES_PER_ROW``
    was launched over, while active (the rows are each launch's last
    argument)."""

    def __init__(self):
        self.rows = {k: 0 for k in flops.KERNEL_BYTES_PER_ROW}
        self._orig = None

    def start(self) -> None:
        self._orig = orig = _build.launch

        def launch(kernel, *args):
            orig(kernel, *args)
            if kernel in self.rows:
                self.rows[kernel] += int(args[-1])
        _build.launch = launch

    def stop(self) -> None:
        _build.launch = self._orig


class BenchEngine(OnlineEngine):
    def __init__(self, cfg, params, *, c: dict, traced: bool, **kw):
        check_hooks()
        super().__init__(cfg, params, clock="wall", **kw)
        self.c = c
        self.traced = traced
        self.stop_at = None
        self.anchor = time.perf_counter()
        self.excluded_s = 0.0
        self.counters = None
        self.spans: Dict[str, list] = {k: [] for k in (
            "decode", "prefill", "kv_check", "kv_refresh", "params_scrub")}
        self.prefill_ms: Dict[int, float] = {}
        self.decoded = self.decode_steps = 0
        self.window = self.launches = None
        self.profile_from = self.profile_to = math.inf
        self.profile_flops = 0.0

    # ----------------------------------------------------------- clock
    def start_clock(self) -> None:
        self.anchor = time.perf_counter()
        self.excluded_s = 0.0

    def _advance(self, now, model_cost, t_wall):
        t = time.perf_counter()
        now = now + (t - self.anchor - self.excluded_s)
        self.anchor, self.excluded_s = t, 0.0
        self._profile_at(now)
        if self.stop_at is not None and now >= self.stop_at:
            raise WindowClosed(now)
        return now

    def _inject_one(self, counters):
        t = time.perf_counter()
        super()._inject_one(counters)
        self.excluded_s += time.perf_counter() - t

    def _profile_at(self, now: float) -> None:
        if self.window is None:
            return
        t = time.perf_counter()
        if not self.window.active and self.window.window_s is None \
                and now >= self.profile_from:
            self.window.start()
            self.launches.start()
        elif self.window.active and now >= self.profile_to:
            self.launches.stop()
            self.window.stop()
        else:
            return
        self.excluded_s += time.perf_counter() - t

    # ----------------------------------------------------------- spans
    def _span(self, label: str, fn, *args):
        """(fn's result, ms) of a call timed between two device
        synchronisations, under a profiler label."""
        sync()
        t = time.perf_counter()
        with torch.profiler.record_function(label):
            out = fn(*args)
            sync()
        ms = (time.perf_counter() - t) * 1e3
        self.spans[label].append(ms)
        return out, ms

    def _run_prefill(self, req, pages):
        if not self.traced:
            return super()._run_prefill(req, pages)
        out, ms = self._span("prefill", super()._run_prefill, req, pages)
        self.spans["prefill"][-1] = (req.prompt_len, ms)
        self.prefill_ms[req.rid] = ms
        if self.window is not None and self.window.active:
            self.profile_flops += flops.prefill_flops(self.c, req.prompt_len)
        return out

    def _run_decode(self):
        if not self.traced:
            return super()._run_decode()
        active = [s for s in self.sched.slots if s is not None]
        out, _ = self._span("decode", super()._run_decode)
        self.decoded += len(active)
        self.decode_steps += 1
        if self.window is not None and self.window.active:
            self.profile_flops += flops.decode_flops(
                self.c, len(active), sum(s.pos + 1 for s in active))
        return out

    def _scrub_kv(self, counters):
        self.counters = counters
        if not self.traced:
            return super()._scrub_kv(counters)
        return self._span("kv_check", super()._scrub_kv, counters)[0]

    def _refresh_kv(self):
        if not self.traced:
            return super()._refresh_kv()
        return self._span("kv_refresh", super()._refresh_kv)[0]

    def _scrub_params(self, counters):
        self.counters = counters
        if not self.traced:
            return super()._scrub_params(counters)
        return self._span("params_scrub", super()._scrub_params, counters)[0]


# ------------------------------------------------------------- the run
def _warm(eng: BenchEngine, mix: dict, vocab: int) -> None:
    """Serve two requests of every prompt length of the mix (each length
    is its own prefill shape; the decode step has one shape), with a KV
    check and refresh every iteration and the final params scrub; then
    forget them."""
    rng = np.random.default_rng(WARM_SEED)
    lens = sorted(set(mix["prompt_len_choices"])) * 2
    warm = [traffic.Request(rid=-1 - i, arrival=0.0,
                            prompt=rng.integers(0, vocab, n, dtype=np.int32),
                            max_new=2) for i, n in enumerate(lens)]
    eng.start_clock()
    eng.run(warm)
    sync()
    eng.sched.completed.clear()
    eng.sched.peak_active = 0
    for v in eng.spans.values():
        v.clear()
    eng.prefill_ms.clear()
    eng.decoded = eng.decode_steps = 0


def _sample(done, seed: int, tokens: int):
    """The longest finished request, then others in a seeded order, until
    ``tokens`` served tokens are covered."""
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i].tokens))
    order = [longest] + [int(i) for i in np.random.default_rng(
        derive(seed, SAMPLE_STREAM)).permutation(len(done)) if i != longest]
    out, n = [], 0
    for i in order:
        if n >= tokens:
            break
        out.append(done[i])
        n += len(done[i].tokens)
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _strike_check(eng: BenchEngine, cell: dict, seed: int):
    """Plant the cell's strikes in the engine's parameters and KV pages,
    scrub the KV pages and then the parameters as an iteration does, and
    the parameters once more. Returns how far the counters lie from the
    design point's response (summed), plus every event of the second
    scrub, and the readings."""
    plan = cell["strikes"]
    leaves = {"/".join(p): t for p, t in
              weights.flat_leaves(eng.param_domain.payload)}
    leaves.update({"kv_cache/" + k: v for k, v in
                   eng.kv_domain.payload["kv_cache"].items()})
    strikes.plant(plan, leaves, derive(seed, STRIKE_STREAM))
    got, again = SLOCounters(), SLOCounters()
    eng._scrub_kv(got)
    eng._scrub_params(got)
    eng._scrub_params(again)
    want = strikes.expected(plan)
    read = {k: int(getattr(got, k)) for k in strikes.COUNTERS}
    second = sum(int(getattr(again, k)) for k in strikes.COUNTERS)
    diff = sum(abs(read[k] - want[k]) for k in want) + second
    return diff, {"want": want, "got": read, "second_scrub_events": second}


def run(ctx, *, drain: bool) -> dict:
    """One run of a serving cell. ``drain``: serve every request due in
    the window to its end (an open-loop cell); else stop the clock at the
    window's end (a batch cell)."""
    c, cell, mix, dev = ctx.config, ctx.cell, ctx.mix, ctx.device
    rec: dict = {"build_s": _port.build_kernels(dev)}
    cfg = _port.model_config(c)
    _port.check_layout(cfg, c)
    page = cell["page_size"]
    max_prompt = max(mix["prompt_len_choices"])
    _port.check_dropless(c, max(-(-max_prompt // page) * page,
                                cell["slots"]))
    params = weights.make(c, ctx.seed, dev)
    reqs = traffic.cell_requests(mix, ctx.seed, c["vocab_size"], ctx.seconds)
    from repro_torch.core import DESIGN_POINTS, Tier
    eng = BenchEngine(
        cfg, params, c=c, traced=ctx.trace, slots=cell["slots"],
        page_size=page, max_prompt_len=max_prompt,
        max_new_cap=max(mix["max_new_choices"]),
        policy=DESIGN_POINTS[cell["policy"]](),
        kv_tier=Tier(cell["kv_tier"]),
        max_prefills_per_step=cell["prefills_per_step"],
        seed=derive(ctx.seed, ENGINE_STREAM))
    del params
    rec["kv_pool_bytes"] = 2 * eng.cache.pool_k.numel() \
        * eng.cache.pool_k.element_size()
    rec["param_bytes"] = eng.param_domain.stats().payload_bytes
    _warm(eng, mix, c["vocab_size"])
    if ctx.trace:
        eng.window, eng.launches = Window(dev), LaunchRows()
        mid = ctx.seconds / 2
        eng.profile_from = mid - cell["trace_s"] / 2
        eng.profile_to = mid + cell["trace_s"] / 2
    eng.stop_at = None if drain else ctx.seconds
    rec["setup_s"] = time.perf_counter() - ctx.t0

    eng.start_clock()
    try:
        eng.run(reqs)
        closed = False
    except WindowClosed:
        closed = True
    sync()
    if eng.window is not None and eng.window.active:
        eng.launches.stop()
        eng.window.stop()
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated() \
        if dev.type == "cuda" else 0

    done = list(eng.sched.completed)
    counters = eng.counters or SLOCounters()
    eng.traced = False          # the verbs below are not the window's
    if closed:    # finish the iteration's write-path ECC, then the closing
        eng._refresh_kv()       # checks the engine's run would have made
        eng._scrub_kv(counters)
        eng._scrub_params(counters)
    in_flight = [s for s in eng.sched.slots if s is not None]
    if drain:
        rec["attempted"] = len(reqs)
        rec["failed"] = len(reqs) - len(done)
        rec["ttft_ms"] = [(d.t_first_token - d.req.arrival) * 1e3
                          for d in done]
        rec["tpot_ms"] = [(d.t_done - d.t_first_token) * 1e3
                          / (len(d.tokens) - 1)
                          for d in done if len(d.tokens) > 1]
    else:
        rec["attempted"] = len(done) + len(in_flight)
        rec["failed"] = 0
        rec["tokens_per_s"] = (sum(len(d.tokens) for d in done) + sum(
            len(s.tokens) for s in in_flight)) / ctx.seconds
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
    strike_diff, rec["strikes"] = _strike_check(eng, cell, ctx.seed)
    fresh = weights.make(c, ctx.seed, dev)
    changed = sum(int((_bits(a) != _bits(b)).sum()) for (_, a), (_, b) in
                  zip(weights.flat_leaves(eng.param_domain.payload),
                      weights.flat_leaves(fresh)))
    sample = [(d.req.prompt, list(d.tokens))
              for d in _sample(done, ctx.seed, cell["sample_tokens"])]
    del eng, done, in_flight
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    prog, ctrl = [], []
    for prompt, toks in sample:
        seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]),
                              dtype=torch.long, device=dev)
        out = torch.as_tensor(toks, dtype=torch.long, device=dev)
        ref = ref_model.logits(fresh, c, seq, last=len(toks))
        prog.append(judge.gaps(ref, out))
        if ctx.control:
            low = ref_model.logits(fresh, c, seq, last=len(toks),
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

"""Driver ``campaign``: the Fig. 2 error-emulation campaign, the port's
``run_campaign`` with ``lm_eval_fn``, in chunks of soft and hard trials,
each chunk seeded from the run's seed, until the window closes. Reports
classified trials over the window's wall time.

Every query's greedy tokens are kept as the program produced them, and
the logits of a clean query and of a seeded sample of trials. After the
window the reference draws each chunk's strikes again, classifies every
trial from the kept tokens, reads the struck bytes the program queried in
the sampled trials, and holds their logits to its own float32 logits on
the same weights, where float32 agrees with float64.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from hrmbench import flops, traffic, weights
from hrmbench.drivers import _port
from hrmbench.profile import Window, sync
from hrmbench.reference import campaign as ref_campaign
from hrmbench.reference import judge
from hrmbench.reference import model as ref_model
from hrmbench.seeds import derive

CAMPAIGN_STREAM, SAMPLE_STREAM = 7, 8
KINDS = ("soft", "hard")
HARD_REPEAT = 3


def _queries_per_chunk(n: int) -> int:
    return 1 + n + HARD_REPEAT * n           # the clean query, then trials


def _first_query(trial: int, n: int) -> int:
    """Index of a trial's first query among all the window's queries."""
    chunk, i = divmod(trial, 2 * n)
    q = chunk * _queries_per_chunk(n) + 1
    return q + i if i < n else q + n + HARD_REPEAT * (i - n)


class _Query:
    """``lm_eval_fn``'s query, keeping every output; for the queries in
    ``capture``, the bytes of the struck leaf that differ from the clean
    one, and for those in ``keep`` the logits the port's ``forward``
    produced; timed and labelled in a traced run."""

    def __init__(self, cfg, tokens, clean: dict, capture: set, keep: set,
                 traced: bool):
        from repro_torch.core.characterize import lm_eval_fn
        from repro_torch.models import forward
        self._forward = forward
        self.base = lm_eval_fn(cfg, {"tokens": tokens}, self.forward)
        self.clean = clean
        self.capture = capture
        self.keep = keep
        self.traced = traced
        self.outputs = []
        self.struck = {}
        self.logits = {}
        self.ms = []

    def forward(self, p, batch, cfg, **kw):
        out = self._forward(p, batch, cfg, **kw)
        if len(self.outputs) in self.keep:
            self.logits[len(self.outputs)] = out[0]
        return out

    def __call__(self, state):
        q = len(self.outputs)
        if q in self.capture:
            for path, leaf in weights.flat_leaves(state):
                ref = self.clean[path]
                if leaf is not ref:
                    a = leaf.reshape(-1).view(torch.uint8)
                    b = ref.reshape(-1).view(torch.uint8)
                    idx = (a != b).nonzero()[:, 0]
                    self.struck[q] = ("/".join(path), {
                        int(i): int(x) for i, x in zip(
                            idx.tolist(), (a[idx] ^ b[idx]).tolist())})
        if not self.traced:
            out, st = self.base(state)
        else:
            sync()
            t = time.perf_counter()
            with torch.profiler.record_function("query"):
                out, st = self.base(state)
                sync()
            self.ms.append((time.perf_counter() - t) * 1e3)
        self.outputs.append(out)
        return out, st


class _Strikes:
    """``MemoryDomain.apply_plan`` timed and labelled (traced runs)."""

    def __init__(self):
        self.ms = []

    def __enter__(self):
        from repro_torch.core.domain import MemoryDomain
        self._orig = orig = MemoryDomain.apply_plan
        log = self.ms

        def apply_plan(dom, *a, **k):
            sync()
            t = time.perf_counter()
            with torch.profiler.record_function("strike"):
                out = orig(dom, *a, **k)
                sync()
            log.append((time.perf_counter() - t) * 1e3)
            return out
        MemoryDomain.apply_plan = apply_plan
        return self

    def __exit__(self, *exc):
        from repro_torch.core.domain import MemoryDomain
        MemoryDomain.apply_plan = self._orig


def run(ctx) -> dict:
    c, cell, mix, dev = ctx.config, ctx.cell, ctx.mix, ctx.device
    from repro_torch.core.characterize import run_campaign
    rec: dict = {"build_s": _port.build_kernels(dev)}
    cfg = _port.model_config(c)
    _port.check_layout(cfg, c)
    B, S, n = mix["batch"], mix["seq"], mix["trials_per_chunk"]
    _port.check_dropless(c, B * S)
    params = weights.make(c, ctx.seed, dev)
    rec["param_bytes"] = sum(t.numel() * t.element_size()
                             for _, t in weights.flat_leaves(params))
    toks = torch.as_tensor(traffic.lm_query(c["vocab_size"], B, S, ctx.seed),
                           device=dev)
    clean = dict(weights.flat_leaves(params))
    rng = np.random.default_rng(derive(ctx.seed, SAMPLE_STREAM))
    sampled = sorted(int(t) for t in rng.choice(
        cell["sample_within"], size=cell["sample_trials"], replace=False))
    capture = {_first_query(t, n) for t in sampled}
    keep = {0} | {q + i for q in capture for i in range(HARD_REPEAT)}
    query = _Query(cfg, toks, clean, capture, keep, ctx.trace)

    # set-up: the query and a strike of each kind, at the window's shapes
    warm = run_campaign(query, params, n_trials=1, seed=derive(
        ctx.seed, CAMPAIGN_STREAM, 2**20), kinds=KINDS,
        hard_repeat=HARD_REPEAT)
    sync()
    del warm
    query.outputs.clear()
    query.struck.clear()
    query.logits.clear()
    query.ms.clear()
    rec["setup_s"] = time.perf_counter() - ctx.t0

    trials, window, strikes = [], None, None
    if ctx.trace:
        window, strikes = Window(dev), _Strikes().__enter__()
        mid, half = ctx.seconds / 2, cell["trace_s"] / 2
        q_at = None
    t0 = time.perf_counter()
    chunk = 0
    while True:
        el = time.perf_counter() - t0
        if window is not None:
            if window.window_s is None and not window.active \
                    and el >= mid - half:
                window.start()
                q_at = len(query.outputs)
            elif window.active and el >= mid + half:
                window.stop()
                rec["profile_queries"] = len(query.outputs) - q_at
        if el >= ctx.seconds:
            break
        res = run_campaign(query, params, n_trials=n,
                           seed=derive(ctx.seed, CAMPAIGN_STREAM, chunk),
                           kinds=KINDS, hard_repeat=HARD_REPEAT)
        trials += res.trials
        chunk += 1
    sync()
    wall = time.perf_counter() - t0
    if window is not None:
        strikes.__exit__()
        if window.active:
            window.stop()
            rec["profile_queries"] = len(query.outputs) - q_at
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated() \
        if dev.type == "cuda" else 0
    rec["trials_per_s"] = len(trials) / wall
    rec["attempted"], rec["failed"] = len(trials), 0
    if ctx.trace:
        rec["query_ms"] = query.ms
        rec["strike_ms_per_trial"] = sum(strikes.ms) / max(len(trials), 1)
        if window.window_s is not None:
            rec["profile"] = {
                "busy_s": window.busy_s, "window_s": window.window_s,
                "kernels": window.kernels, "top_ops": window.top_ops,
                "idle_by_host": window.idle_by_host,
                "flops": rec["profile_queries"] * flops.query_flops(c, B, S)}

    # ------------------------------------------ correctness, window closed
    outputs, struck, logits = query.outputs, query.struck, query.logits
    del query, params, clean
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    fresh = weights.make(c, ctx.seed, dev)
    leaves = dict(weights.flat_leaves(fresh))
    nbytes = {"/".join(p): v.numel() * v.element_size()
              for p, v in leaves.items()}
    table = ref_campaign.leaf_table(weights.flat_leaves(fresh))
    q_chunk = _queries_per_chunk(n)
    golden = outputs[0]
    golden_diff = sum(not torch.equal(outputs[k * q_chunk], golden)
                      for k in range(chunk))
    draw_diff = class_diff = 0
    plans = []
    for k in range(chunk):
        drawn = ref_campaign.draws(table, n, derive(ctx.seed,
                                                     CAMPAIGN_STREAM, k))
        for i, (kind, path, ws, bs) in enumerate(drawn):
            p_path, p_kind, p_out = trials[k * 2 * n + i]
            draw_diff += (p_path, p_kind) != (path, kind)
            fl = ref_campaign.flips(ws, bs, nbytes[path])
            plans.append((kind, path, fl))
            q = _first_query(k * 2 * n + i, n)
            outs = outputs[q:q + (HARD_REPEAT if kind == "hard" else 1)]
            want = ref_campaign.trial_outcome(kind, outs, golden, bool(fl))
            class_diff += want != p_out.name.lower()
    struck_diff = 0
    judged = [(0, None)]
    for t_i in (t for t in sampled if t < len(trials)):
        kind, path, fl = plans[t_i]
        q = _first_query(t_i, n)
        got = struck.get(q, (path, {}))
        struck_diff += got != (path, fl)
        judged.append((q, (path, fl)))
        if kind == "hard":
            judged += [(q + 1, None), (q + 2, (path, fl))]
    prog, ctrl, detail = [], [], []
    rows_med, ctrl_rows = [], []
    crash_diff = ill = not_argmax = 0
    cache = {}         # (logits, conditioned) of the clean and last struck
    for q, strike in judged:
        key = None if strike is None else (strike[0],
                                           tuple(sorted(strike[1].items())))
        if key not in cache:
            w = fresh if strike is None else _with_leaf(
                fresh, strike[0], ref_campaign.struck(
                    leaves[tuple(strike[0].split("/"))], strike[1]))
            cache = {k: v for k, v in cache.items() if k is None}
            ref = torch.stack([ref_model.logits(w, c, row) for row in toks])
            ref64 = torch.stack([ref_model.logits(
                w, c, row, prec=ref_model.FLOAT64) for row in toks])
            cache[key] = (ref, judge.conditioned(ref, ref64))
            del ref64
            if ctx.control and torch.isfinite(ref).all():
                low = torch.stack([ref_model.logits(
                    w, c, row, prec=ref_model.Precision(fp8=True))
                    for row in toks])
                c_err = judge.logit_error(ref, low)
                ctrl.append(c_err[cache[key][1]])
                ctrl_rows += judge.row_medians(c_err, cache[key][1], B)
                del low, c_err
        ref, ok = cache[key]
        crashed = bool((outputs[q] < 0).any())
        if crashed or not torch.isfinite(ref).all():
            # the crash marker agrees when some reference logit is not
            # finite, as lm_eval_fn marks a batch with any such logit
            crash_diff += crashed == bool(torch.isfinite(ref).all())
            detail.append({"strike": strike, "crash": crashed})
            continue
        err = judge.logit_error(ref, logits[q])
        prog.append(err[ok])
        rows_med += judge.row_medians(err, ok, B)
        not_argmax += int((outputs[q] != logits[q].argmax(-1)).sum())
        ill += int((~ok).sum())
        detail.append({"strike": strike, "max": float(err.max()),
                       "mean": float(err.mean()), "ill": int((~ok).sum())})
    rec["reference_s"] = time.perf_counter() - t
    judged_s = judge.summary(torch.cat(prog)) if prog else \
        {"median": float("inf"), "n": 0}
    judged_s["row_median_max"] = max(rows_med, default=float("inf"))
    rec["judged"] = judged_s
    rec["judged_queries"] = detail
    rec["ill_conditioned_positions"] = ill
    if ctx.control:
        rec["control"] = dict(judge.summary(torch.cat(ctrl)),
                              row_median_max=max(ctrl_rows))
    lim = cell["limits"]
    rec["checks"] = [
        ("logit_error_row_median_max", judged_s["row_median_max"],
         lim["logit_error_row_median_max"], "max"),
        ("tokens_not_their_logits_first", not_argmax, 0, "max"),
        ("crash_verdicts_differing", crash_diff, 0, "max"),
        ("strikes_drawn_differently", draw_diff, 0, "max"),
        ("trials_classified_differently", class_diff, 0, "max"),
        ("struck_bytes_differently", struck_diff, 0, "max"),
        ("clean_queries_differing", golden_diff, 0, "max"),
        ("trials", len(trials), lim["trials"], "min"),
        ("positions_judged", judged_s["n"], lim["positions_judged"],
         "min"),
    ]
    return rec


def _with_leaf(w: dict, path: str, leaf: torch.Tensor) -> dict:
    """A shallow copy of the nested weights with one leaf replaced."""
    keys = path.split("/")
    out = dict(w)
    node = out
    for k in keys[:-1]:
        node[k] = dict(node[k])
        node = node[k]
    node[keys[-1]] = leaf
    return out

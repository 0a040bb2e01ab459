"""The port's spans and counters (``repro_torch.telemetry``) on the CPU, at
tiny granite-moe-3b-a800m: a tiny ``OnlineEngine`` run and a tiny Fig. 2
campaign, each once plain and once under ``recording()``.

Recording changes no token and no report; off, nothing is recorded. Under
``recording()`` the span tree is the engine's loop (one
``engine.iteration`` a pass, its KV check and refresh inside it, a
decode's inputs, dispatch and fetch inside the decode), every request's
prefill and queue wait carry its ``rid``, the bytes the KV ECC packs are
the KV tier's packed rows twice an iteration, and the MoE counters are
T·K and E·C. Under ``torch.profiler`` a span is a user annotation and
an ``inner`` span (inside the forward) is not. Each of the benchmark's
readers of these spans
(``hrmbench/metrics/*.py``) reads what an independent formula gives.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs import get_tiny
from repro_torch.core import (DESIGN_POINTS, HRMPolicy, MemoryDomain, Tier,
                              characterize)
from repro_torch.kernels.ops import LANES, words_per_tensor
from repro_torch.models import forward, init_params, mlp
from repro_torch.serve import OnlineEngine, TrafficConfig, generate_trace

ARCH = "granite-moe-3b-a800m"
ROW_BYTES = LANES * 8
METRICS = Path(__file__).resolve().parents[1] / "hrmbench" / "metrics"
PLANE = dict(slots=4, page_size=8, seed=7, max_prompt_len=16,
             max_new_cap=8, scrub_every=4)
SERVING_METRICS = ("decode_host_ms", "kv_ecc_packed_mb",
                   "decode_slot_use.chat", "moe_slot_use.chat")
CAMPAIGN_METRICS = ("query_host_ms", "strike_packed_mb",
                    "moe_slot_use.campaign")
HARD_REPEAT = 3


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "telemetry_metric_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _children(records, i):
    return [s for s in records if s.parent == i]


def _under(records, i, counter):
    """Counter ``counter`` summed over span ``i`` and every span inside it."""
    total, todo = 0, [i]
    while todo:
        j = todo.pop()
        total += (records[j].counts or {}).get(counter, 0)
        todo += [k for k, s in enumerate(records) if s.parent == j]
    return total


def _ms(spans):
    return sum(s.end_ns - s.start_ns for s in spans) * 1e-6


@pytest.fixture(scope="module")
def cfg():
    return get_tiny(ARCH)


@pytest.fixture(scope="module")
def params(cfg):
    return init_params(cfg, seed=0, device="cpu")


@pytest.fixture(scope="module")
def serving(cfg, params):
    """The tiny engine run plain and recorded: reports, tokens, what the
    plain run recorded, the recorded run's spans and the readers'
    values, each read right after its run."""
    trace = generate_trace(TrafficConfig(n_requests=12, rate=16.0,
                                         process="bursty", seed=7),
                           cfg.vocab_size)

    def engine():
        return OnlineEngine(cfg, params, **PLANE,
                            policy=DESIGN_POINTS["detect_recover"](),
                            kv_tier=Tier("parity_r"))

    telemetry.reset()
    plain = engine().run(trace)
    off = (telemetry.records(), telemetry.summary())
    eng = engine()
    with telemetry.recording():
        recorded = eng.run(trace)
    reads = {m: _reader(m)({}) for m in SERVING_METRICS}
    return dict(trace=trace, plain=plain, recorded=recorded, off=off,
                engine=eng, records=telemetry.records(),
                summary=telemetry.summary(), reads=reads)


@pytest.fixture(scope="module")
def campaign(cfg, params):
    """A tiny campaign (2 soft and 2 hard trials, a 2 x 32 query) plain
    and recorded, and the readers' values after the recorded one."""
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 32), dtype=np.int64))
    ev = characterize.lm_eval_fn(cfg, {"tokens": toks}, forward)

    def run():
        return characterize.run_campaign(ev, params, n_trials=2, seed=3,
                                         hard_repeat=HARD_REPEAT)

    plain = run()
    with telemetry.recording():
        recorded = run()
    reads = {m: _reader(m)({}) for m in CAMPAIGN_METRICS}
    return dict(tokens=toks, plain=plain, recorded=recorded,
                records=telemetry.records(), reads=reads)


# --------------------------------------------------------------- recorder
def test_off_is_a_shared_no_op():
    assert not telemetry.enabled()
    telemetry.reset()
    assert telemetry.span("a", rid=1) is telemetry.span("b")
    with telemetry.span("a"):
        telemetry.count("n", 3)
    telemetry.interval("w", 0, 5)
    assert telemetry.records() == []
    assert telemetry.summary() == {"spans": {}, "counters": {}}


def test_summary_self_time_and_counters():
    """Self time is a span less the spans opened inside it; a span's
    counters include its children's; counts with no span open, and
    intervals, nest in nothing."""
    with telemetry.recording():
        telemetry.count("n", 1)
        with telemetry.span("outer", rid=4):
            telemetry.count("n", 2)
            for _ in range(2):
                with telemetry.span("inner"):
                    telemetry.count("n", 5)
                    torch.ones(64).sum()
        telemetry.interval("wait", 10, 1_000_010, rid=4)
    rec = telemetry.records()
    assert [s.name for s in rec] == ["outer", "inner", "inner", "wait"]
    assert [s.parent for s in rec] == [-1, 0, 0, -1]
    assert rec[0].attrs == {"rid": 4} and rec[3].attrs == {"rid": 4}
    s = telemetry.summary()
    outer, inner = s["spans"]["outer"], s["spans"]["inner"]
    assert outer["count"] == 1 and inner["count"] == 2
    assert outer["total_ms"] == pytest.approx(_ms(rec[:1]))
    assert outer["self_ms"] == pytest.approx(_ms(rec[:1]) - _ms(rec[1:3]))
    assert inner["self_ms"] == pytest.approx(inner["total_ms"])
    assert outer["counters"] == {"n": 12} and inner["counters"] == {"n": 10}
    assert s["spans"]["wait"] == {"count": 1, "total_ms": 1.0,
                                  "self_ms": 1.0, "counters": {}}
    assert s["counters"] == {"n": 13}
    with telemetry.recording():         # a new record
        pass
    assert telemetry.records() == []


# ------------------------------------------------------------ the engine
def test_recording_changes_no_token_and_off_records_nothing(serving):
    """(a) Plain, nothing is recorded; recorded, the report and every
    response equal the plain run's."""
    records, summary = serving["off"]
    assert records == [] and summary == {"spans": {}, "counters": {}}
    (rep0, resp0), (rep1, resp1) = serving["plain"], serving["recorded"]
    assert rep1.to_dict() == rep0.to_dict()
    assert resp1 == resp0
    assert rep0.completed == len(serving["trace"])


def test_engine_span_tree(serving):
    """(b) One ``engine.iteration`` a loop pass with one KV check and one
    refresh inside it; every prefill and queue wait carries an admitted
    request's ``rid``; a decode's inputs, dispatch and fetch lie inside it,
    in that order."""
    rec = serving["records"]
    iters = [i for i, s in enumerate(rec) if s.name == "engine.iteration"]
    assert [rec[i].attrs["it"] for i in iters] == list(range(len(iters)))
    assert all(rec[i].parent == -1 for i in iters)
    for i in iters:
        names = [s.name for s in _children(rec, i)]
        assert names.count("engine.kv_check") == 1
        assert names.count("engine.kv_refresh") == 1
    rids = sorted(serving["recorded"][1])
    for name in ("engine.prefill", "engine.queued"):
        assert sorted(s.attrs["rid"] for s in rec if s.name == name) == rids
    decodes = [i for i, s in enumerate(rec) if s.name == "engine.decode"]
    assert len(decodes) == serving["recorded"][0].counters["decode_steps"]
    for i in decodes:
        kids = _children(rec, i)
        assert [s.name for s in kids] == ["decode.inputs", "decode.dispatch",
                                          "decode.fetch"]
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns <= b.start_ns
        assert rec[i].start_ns <= kids[0].start_ns
        assert kids[-1].end_ns <= rec[i].end_ns


def test_kv_ecc_packs_both_pools_twice_an_iteration(serving):
    """(c) The bytes packed under an iteration's KV check and refresh are
    the KV tier's packed rows, from the domain spec, twice."""
    rows = sum(s.rows for s in serving["engine"].kv_domain.spec.leaves
               if s.tier is Tier.PARITY_R)
    rec = serving["records"]
    for i, s in enumerate(rec):
        if s.name != "engine.iteration":
            continue
        kids = [j for j, k in enumerate(rec) if k.parent == i
                and k.name in ("engine.kv_check", "engine.kv_refresh")]
        assert sum(_under(rec, j, "packed_bytes") for j in kids) \
            == 2 * rows * ROW_BYTES


def test_moe_counters_are_routed_copies_and_expert_slots(cfg, params):
    """(d) One dispatch of T tokens counts T·K routed copies and
    E·_capacity(T) expert slots, whatever T."""
    moe = cfg.moe
    layer = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    for T in (5, 24):
        x = torch.randn(1, T, cfg.d_model)
        with telemetry.recording():
            mlp.moe_apply(layer, x, cfg)
        c = telemetry.summary()["counters"]
        assert c["moe_routed"] == T * moe.top_k
        assert c["moe_slots"] == moe.n_experts * mlp._capacity(T, moe)
        assert [s.name for s in telemetry.records()] == [
            "moe.route", "moe.dispatch", "moe.experts", "moe.combine"]


def test_spans_are_profiler_annotations(cfg, params):
    """(e) Under ``torch.profiler`` the spans record; a ``span`` is a user
    annotation, an ``inner`` span (the stretches inside the forward) is
    not; once the profiler stops, nothing records."""
    from torch.profiler import ProfilerActivity, profile
    telemetry.reset()
    toks = torch.zeros((1, 8), dtype=torch.long)
    ev = characterize.lm_eval_fn(cfg, {"tokens": toks}, forward)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert telemetry.enabled()
        ev(params)
    assert not telemetry.enabled()
    inner = {"layer.attn", "layer.ffn", "model.head", "moe.route",
             "moe.dispatch", "moe.experts", "moe.combine"}
    names = [s.name for s in telemetry.records()]
    assert set(names) == inner | {"campaign.query"}
    assert names.count("layer.attn") == cfg.n_layers
    shown = {e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()}
    assert "campaign.query" in shown and not inner & shown
    n = len(telemetry.records())
    with telemetry.span("after"):
        pass
    assert len(telemetry.records()) == n
    telemetry.reset()


def test_serving_readers_equal_their_formulas(cfg, serving):
    """(f) The chat cell's readers against formulas of the run: the KV
    tier's rows, the tokens the decode steps served over the slots they
    ran over, the routed copies over the expert slots of every prefill
    (padded to whole pages) and decode step, and the decode's spans."""
    reads, rec = serving["reads"], serving["records"]
    eng = serving["engine"]
    rep, resp = serving["recorded"]
    rows = sum(s.rows for s in eng.kv_domain.spec.leaves
               if s.tier is Tier.PARITY_R)
    assert reads["kv_ecc_packed_mb"] == pytest.approx(
        2 * rows * ROW_BYTES / 1e6, rel=1e-12)
    steps, slots = rep.counters["decode_steps"], PLANE["slots"]
    served = sum(len(t) - 1 for t in resp.values())
    assert reads["decode_slot_use.chat"] == pytest.approx(
        served / (steps * slots) * 100, rel=1e-12)
    moe, page = cfg.moe, PLANE["page_size"]
    ts = [-(-r.prompt_len // page) * page for r in serving["trace"]] \
        + [slots] * steps
    routed = sum(t * moe.top_k for t in ts)
    cap = sum(moe.n_experts * mlp._capacity(t, moe) for t in ts)
    assert reads["moe_slot_use.chat"] == pytest.approx(routed / cap * 100,
                                                       rel=1e-12)
    per = [[s for s in rec if s.name == k]
           for k in ("decode.inputs", "decode.dispatch")]
    assert len(per[0]) == len(per[1]) == steps
    assert reads["decode_host_ms"] == pytest.approx(
        (_ms(per[0]) + _ms(per[1])) / steps, rel=1e-9)


# ----------------------------------------------------------- the campaign
def test_campaign_spans_and_readers(cfg, campaign):
    """(f) The campaign's outcomes are the plain run's; a trial's strikes
    are its applications of the plan (1 soft, ``HARD_REPEAT`` hard), each
    packing its leaf's rows once; the queries are the golden one and one
    a soft trial, ``HARD_REPEAT`` a hard; the readers equal those
    formulas."""
    plain, recorded = campaign["plain"], campaign["recorded"]
    assert recorded.trials == plain.trials
    rec, reads = campaign["records"], campaign["reads"]
    trials = [(i, s) for i, s in enumerate(rec) if s.name == "campaign.trial"]
    assert [(s.attrs["path"], s.attrs["kind"]) for _, s in trials] == \
        [(p, k) for p, k, _ in recorded.trials]
    for i, s in trials:
        names = [k.name for k in _children(rec, i)]
        apps = HARD_REPEAT if s.attrs["kind"] == "hard" else 1
        assert names.count("campaign.strike") == apps
        assert names[-1] == "campaign.verdict"
    dom = MemoryDomain.protect(init_params(cfg, seed=0, device="meta"),
                               HRMPolicy("campaign/params", {}))
    rows = {s.path: words_per_tensor(torch.empty(s.shape, dtype=getattr(
        torch, s.dtype), device="meta")) // LANES for s in dom.spec.leaves}
    packed = sum((HARD_REPEAT if k == "hard" else 1) * rows[p] * ROW_BYTES
                 for p, k, _ in recorded.trials)
    assert reads["strike_packed_mb"] == pytest.approx(
        packed / len(trials) / 1e6, rel=1e-12)
    queries = [s for s in rec if s.name == "campaign.query"]
    assert len(queries) == 1 + sum(HARD_REPEAT if k == "hard" else 1
                                   for _, k, _ in recorded.trials)
    assert reads["query_host_ms"] == pytest.approx(
        _ms(queries) / len(queries), rel=1e-9)
    T, moe = campaign["tokens"].numel(), cfg.moe
    assert reads["moe_slot_use.campaign"] == pytest.approx(
        T * moe.top_k / (moe.n_experts * mlp._capacity(T, moe)) * 100,
        rel=1e-12)

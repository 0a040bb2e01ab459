"""The port's online serving plane against the JAX reference on the CPU:
request traces, the router, the paged KV allocator, paged decode against
the port's contiguous decode, ``OnlineEngine.run`` under the model clock,
the ``PEER_COPY`` recovery of ``MemoryDomain.recover`` and the
``launch.serve_online`` CLI, on tiny llama3-8b with the reference's
parameters carried across through numpy.

Tolerances: none. Traces, allocator tables and SLO reports are compared
exactly. Paged decode equals the port's contiguous ``decode_step`` bit for
bit in the model's own bf16 compute. Where the two packages' engines are
compared, the model computes in float32, where their greedy tokens agree
exactly (as in ``tests/test_torch_serve.py``); every counter, latency and
availability of the report is then equal, and so is every response. The
reference runs its kernels in Pallas interpret mode, as its own tests run
them. Page 0, the null page that inactive slots write, is never compared.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as jget_tiny
from repro.core import MemoryDomain as JDomain
from repro.core import Response as JResponse
from repro.core import RetirementMap as JRetirementMap
from repro.core import Tier as JTier
from repro.core.policy import DESIGN_POINTS as JDESIGN_POINTS
from repro.core.trace import ErrorTrace as JErrorTrace
from repro.launch import serve_online as jserve_online
from repro.models import init_params as jinit_params
from repro.serve import OnlineEngine as JOnlineEngine
from repro.serve import PagedKVCache as JPagedKVCache
from repro.serve import Request as JRequest
from repro.serve import RequestRouter as JRequestRouter
from repro.serve import TrafficConfig as JTrafficConfig
from repro.serve import generate_trace as jgenerate_trace
from repro_torch.configs import get_tiny
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import (DESIGN_POINTS, InjectionPlan, MemoryDomain,
                              Response, RetirementMap, Tier, tracegen,
                              tree)
from repro_torch.core.trace import ErrorTrace
from repro_torch.launch import serve_online
from repro_torch.models import decode_step, forward, init_cache, init_params
from repro_torch.models.transformer import paged_decode_logits, prefill_write
from repro_torch.runtime.serve_loop import serve_batch
from repro_torch.serve import (NULL_PAGE, OnlineEngine, PagedKVCache,
                               Request, RequestRouter, SLOCounters,
                               TrafficConfig, generate_trace, incorrect_rate)

CPU = "cpu"
CFG = get_tiny("llama3-8b")
# benchmarks/serve_slo.py's trace and plane
SLO_TRAFFIC = dict(n_requests=40, rate=16.0, process="bursty", seed=7)
SLO_PLANE = dict(slots=4, page_size=8, seed=7)
# tests/test_serve_plane.py's short trace
SHORT_TRAFFIC = dict(n_requests=12, rate=40.0, seed=3)


@pytest.fixture(scope="module")
def params():
    """The port's own bf16-compute parameters."""
    return init_params(CFG, seed=0, device=CPU)


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, port cfg, reference params, port params) in float32
    compute, the reference's parameters carried across."""
    jcfg = jget_tiny("llama3-8b").replace(compute_dtype="float32")
    cfg = CFG.replace(compute_dtype="float32")
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, state_from_numpy(jax.tree.map(np.asarray, jp),
                                           device=CPU)


def _prompts(b, s0, seed=1):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, size=(b, s0)).astype(np.int32)


def _trace(prompts, arrivals, max_new):
    return [Request(rid=i, arrival=float(arrivals[i]), prompt=prompts[i],
                    max_new=max_new) for i in range(len(prompts))]


def _traces(jcfg, **kw):
    """The same trace drawn by both packages."""
    return (jgenerate_trace(JTrafficConfig(**kw), jcfg.vocab_size),
            generate_trace(TrafficConfig(**kw), jcfg.vocab_size))


# ---------------------------------------------------------- traffic, router
@pytest.mark.parametrize("seed", (0, 3, 7))
@pytest.mark.parametrize("process", ("poisson", "bursty"))
def test_generate_trace_equals_reference(process, seed):
    kw = dict(n_requests=30, rate=12.0, process=process, seed=seed,
              prompt_len_choices=(8, 16, 32), max_new_choices=(4, 8))
    want = jgenerate_trace(JTrafficConfig(**kw), CFG.vocab_size)
    got = generate_trace(TrafficConfig(**kw), CFG.vocab_size)
    assert len(got) == len(want) == 30
    for g, w in zip(got, want):
        assert (g.rid, g.arrival, g.max_new) == (w.rid, w.arrival, w.max_new)
        assert g.prompt.dtype == w.prompt.dtype
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert g.footprint_tokens() == w.footprint_tokens()
    with pytest.raises(ValueError, match="arrival process"):
        generate_trace(TrafficConfig(process="flash"), CFG.vocab_size)


def test_router_sheds_on_bounded_queue():
    """Five requests at once into a queue of three: the same two are shed
    by both packages, and the rest come out in arrival order."""
    routers = []
    for Req, Router in ((JRequest, JRequestRouter), (Request, RequestRouter)):
        trace = [Req(rid=i, arrival=0.01 * (4 - i),
                     prompt=np.zeros(4, np.int32), max_new=2)
                 for i in range(5)]
        router = Router(trace, max_queue=3)
        assert router.poll(1.0) == 3
        assert len(router) == 3 and len(router.shed) == 2
        assert router.drained is False and router.next_arrival() is None
        routers.append(router)
    (jr, r) = routers
    assert [q.rid for q in r.queue] == [q.rid for q in jr.queue]
    assert [q.rid for q in r.shed] == [q.rid for q in jr.shed] == [1, 0]
    req = r.take()
    r.requeue(req)
    assert r.peek() is req and r.peak_queue == 3


# ------------------------------------------------------- paged allocator
def test_allocator_no_aliasing_and_no_leak():
    """The reference's allocator test, with the page tables of the two
    packages equal after every step."""
    caches = (JPagedKVCache(jget_tiny("llama3-8b"), n_pages=9, page_size=8,
                            slots=3, max_pages_per_slot=3),
              PagedKVCache(CFG, n_pages=9, page_size=8, slots=3,
                           max_pages_per_slot=3, device=CPU))
    for c in caches:
        p0 = c.alloc(0, 17)          # 3 pages
        p1 = c.alloc(1, 8)           # 1 page
        assert len(p0) == 3 and len(p1) == 1
        assert NULL_PAGE not in set(p0) | set(p1)
        assert not set(p0.tolist()) & set(p1.tolist())
        c.check_invariants()
        assert c.free_pages == 8 - 4
        c.release(0)
        c.check_invariants()
        assert c.free_pages == 7
        c.alloc(0, 24)               # released pages and slot reusable
        c.check_invariants()
    np.testing.assert_array_equal(caches[1].table, caches[0].table)
    cache = caches[1]
    shape = (CFG.n_layers, 9, 8, CFG.n_kv_heads, CFG.head_dim)
    assert cache.pool_k.shape == cache.pool_v.shape == shape
    assert cache.pool_k.dtype == torch.bfloat16
    table = cache.device_table()
    assert table.dtype == torch.int64 and table.device.type == "cpu"
    np.testing.assert_array_equal(table.numpy(), cache.table)
    cache.release_all()
    cache.check_invariants()
    assert cache.free_pages == 8
    cache._free.append(cache._free[0])          # a page freed twice
    with pytest.raises(AssertionError, match="leak"):
        cache.check_invariants()


def test_allocator_capacity_and_double_alloc_guards():
    cache = PagedKVCache(CFG, n_pages=4, page_size=8, slots=2,
                         max_pages_per_slot=2, device=CPU)
    with pytest.raises(ValueError):
        cache.alloc(0, 100)          # > max_pages_per_slot
    cache.alloc(0, 16)
    with pytest.raises(RuntimeError):
        cache.alloc(0, 8)            # slot already holds pages
    with pytest.raises(MemoryError):
        cache.alloc(1, 16)           # only 1 free page left
    assert not cache.can_admit(16) and cache.can_admit(8)
    with pytest.raises(ValueError, match="null page"):
        PagedKVCache(CFG, n_pages=1, page_size=8, slots=1,
                     max_pages_per_slot=1, device=CPU)
    vlm = dict(n_pages=4, page_size=8, slots=1, max_pages_per_slot=1)
    got = PagedKVCache(CFG.replace(family="vlm"), device=CPU, **vlm)
    want = JPagedKVCache(jget_tiny("llama3-8b").replace(family="vlm"), **vlm)
    assert tuple(got.pool_k.shape) == want.pool_k.shape
    assert got.free_pages == want.free_pages
    with pytest.raises(ValueError, match="attention-cache"):
        PagedKVCache(CFG.replace(family="ssm"), n_pages=4, page_size=8,
                     slots=1, max_pages_per_slot=1, device=CPU)


# ----------------------------------------------------------- bit-identity
def test_paged_decode_bit_identical_to_contiguous_decode(params):
    """Three slots prefilled page by page, then eight decode steps: the
    paged logits equal ``decode_step``'s on the contiguous cache bit for
    bit, and each slot's pages hold the contiguous cache's rows."""
    b, s0, new, ps = 3, 8, 8, 8
    prompts = torch.from_numpy(_prompts(b, s0).astype(np.int64))
    cache = PagedKVCache(CFG, n_pages=2 * b + 1, page_size=ps, slots=b,
                         max_pages_per_slot=2, device=CPU)
    full = init_cache(CFG, b, s0 + new, device=CPU)
    firsts, tok = [], []
    for i in range(b):
        pages = torch.from_numpy(cache.alloc(i, s0 + new).astype(np.int64))
        first, ok = prefill_write(params, cache.pools,
                                  prompts[i:i + 1], s0, pages[:1], CFG, ps)
        assert bool(ok)
        firsts.append(int(first))
        logits, _, c = forward(params, {"tokens": prompts[i:i + 1]}, CFG,
                               return_cache=True)
        for k in ("k", "v"):
            full[k][:, i, :s0] = c[k][:, 0]
        tok.append(int(torch.argmax(logits[0, -1])))
    assert firsts == tok
    tok = torch.tensor(tok)
    table = cache.device_table()
    for t in range(new):
        want, full = decode_step(params, tok, s0 + t, full, CFG)
        got = paged_decode_logits(params, cache.pools, table, tok,
                                  torch.full((b,), s0 + t), CFG, ps)
        assert torch.equal(got, want), t
        for i in range(b):
            k, v = cache.contiguous_view(i, s0 + t + 1)
            assert torch.equal(k[:, 0], full["k"][:, i, :s0 + t + 1])
            assert torch.equal(v[:, 0], full["v"][:, i, :s0 + t + 1])
        tok = torch.argmax(want, dim=-1)


def test_engine_equals_contiguous_serve_batch(params):
    """The reference's two oracle tests on the port: one batch through the
    engine gives ``serve_batch``'s tokens; requests arriving mid-stream
    join the running batch and still get the tokens of a solo server."""
    b, s0, new = 3, 8, 8
    prompts = _prompts(b, s0)
    oracle, _ = serve_batch(CFG, params, torch.from_numpy(prompts), new)
    eng = OnlineEngine(CFG, params, slots=b, page_size=8, max_prompt_len=s0,
                       max_new_cap=new, max_prefills_per_step=b,
                       debug_invariants=True)
    _, resp = eng.run(_trace(prompts, [0.0] * b, new))
    np.testing.assert_array_equal(oracle.numpy(),
                                  np.stack([resp[i] for i in range(b)]))

    b, new = 4, 6
    prompts = _prompts(b, s0, seed=2)
    eng = OnlineEngine(CFG, params, slots=2, page_size=8, max_prompt_len=s0,
                       max_new_cap=new, max_prefills_per_step=1,
                       debug_invariants=True)
    rep, resp = eng.run(_trace(prompts, [0.03 * i for i in range(b)], new))
    assert rep.completed == b and rep.peak_active == 2
    for i in range(b):
        solo, _ = serve_batch(CFG, params,
                              torch.from_numpy(prompts[i:i + 1]), new)
        np.testing.assert_array_equal(solo.numpy()[0], resp[i])
    eng.cache.check_invariants()
    assert eng.sched.n_active == 0
    assert eng.cache.free_pages == eng.cache.n_pages - 1


# ------------------------------------------- the engine against the reference
def _case(name, tmp_path):
    """(trace kwargs, engine kwargs, replayed trace path or None, storm
    errors) of one scenario. Every scenario runs the same plane, so the
    reference compiles its programs for one pool shape."""
    dr = dict(policy="detect_recover", kv_tier="parity_r", scrub_every=4)
    short = dict(SLO_PLANE, seed=1)
    if name == "zero":
        return SLO_TRAFFIC, SLO_PLANE, None, 0
    if name == "slo_storm":
        return SLO_TRAFFIC, dict(SLO_PLANE, **dr), None, 540
    if name == "typical_server":
        return SHORT_TRAFFIC, dict(short, policy="typical_server",
                                   kv_tier="secded", scrub_every=4), None, 540
    if name == "unprotected":
        # seed 1: one strike drives the logits non-finite, so the crash
        # reset runs in both packages
        return SHORT_TRAFFIC, short, None, 540
    if name == "peer":
        return SHORT_TRAFFIC, dict(short, peer_recovery=True, **dr), None, \
            300
    assert name == "trace"
    path = tmp_path / "month.npz"
    tracegen.generate_error_trace(
        tracegen.TraceGenConfig(n_events=120, n_dimms=4), seed=5).save(path)
    return SHORT_TRAFFIC, dict(short, **dr), path, 0


@pytest.mark.parametrize("name", ("zero", "slo_storm", "typical_server",
                                  "unprotected", "peer", "trace"))
def test_engine_run_equals_reference(pair, tmp_path, name):
    """``OnlineEngine.run`` under the model clock, both packages on one
    trace, parameters and seed: ``SLOReport.to_dict()`` equal in every
    field and every response equal token for token. ``zero`` and
    ``slo_storm`` are ``benchmarks/serve_slo.py``'s golden and storm
    passes; the others run ``tests/test_serve_plane.py``'s short trace."""
    jcfg, cfg, jp, p = pair
    traffic, eng, replay, storm = _case(name, tmp_path)
    jtrace, trace = _traces(jcfg, **traffic)
    mk = {k: v for k, v in eng.items() if k not in ("policy", "kv_tier")}
    pol = eng.get("policy")
    tier = eng.get("kv_tier", "none")
    geometry = dict(max_prompt_len=16, max_new_cap=8)
    jeng = JOnlineEngine(jcfg, jp, **geometry, **mk,
                         policy=JDESIGN_POINTS[pol]() if pol else None,
                         kv_tier=JTier(tier))
    teng = OnlineEngine(cfg, p, **geometry, **mk, debug_invariants=True,
                        policy=DESIGN_POINTS[pol]() if pol else None,
                        kv_tier=Tier(tier))
    if replay is not None:
        jkw = {"error_trace": JErrorTrace.load(replay)}
        tkw = {"error_trace": ErrorTrace.load(replay)}
    else:
        jkw = tkw = {"storm_errors": storm}
    jrep, jresp = jeng.run(jtrace, **jkw)
    rep, resp = teng.run(trace, **tkw)
    assert rep.to_dict() == jrep.to_dict()
    assert resp == jresp
    c = rep.counters
    assert rep.completed + rep.shed == len(trace)
    if name == "zero":
        assert rep.availability == 1.0 and c["crash_events"] == 0
    if storm:
        assert c["injected_params"] + c["injected_kv"] == storm
    if name == "slo_storm":
        assert c["recovery_events"] > 0 and rep.availability >= 0.9990
    if name == "typical_server":
        assert c["params_corrected"] > 0
    if name == "unprotected":
        assert c["crash_events"] >= 1
    if name == "peer":
        assert c["peer_recovery_events"] > 0 and c["recovery_events"] == 0
    if name == "trace":
        assert c["injected_params"] + c["injected_kv"] == 120
    teng.cache.check_invariants()
    assert teng.cache.free_pages == teng.cache.n_pages - 1


# ---------------------------------------------------- PEER_COPY, aliasing
def test_peer_copy_recover_equals_reference(pair):
    """``Response.PEER_COPY`` reloads like the disk copy: the same events,
    named ``peer_copy`` (``+retire`` once a leaf's strikes reach
    ``retire_after``), the same retired blocks, the payload restored bit
    for bit."""
    _, _, jp, p = pair
    jdom = JDomain.protect(jp, JDESIGN_POINTS["detect_recover"]())
    tdom = MemoryDomain.protect(p, DESIGN_POINTS["detect_recover"]())
    par = tdom.paths(protected_only=True)
    jdom, jev = jdom.inject(np.random.default_rng(4), 3, hard=True,
                            paths=par, multi_bit_fraction=0.0)
    tdom, tev = tdom.inject(np.random.default_rng(4), 3, hard=True,
                            paths=par, multi_bit_fraction=0.0)
    assert tev == jev
    jclean = {s.path: np.asarray(jax.tree_util.tree_leaves(jp)[s.pos])
              for s in jdom.spec.leaves}
    tclean = {s.path: tree.leaves(p)[s.pos].clone()
              for s in tdom.spec.leaves}
    jstrikes, tstrikes = {}, {}
    jret, tret = JRetirementMap(), RetirementMap()
    actions = []
    for _ in range(2):
        jfix, jrep = jdom.scrub()
        tfix, trep = tdom.scrub()
        assert trep.needs_recovery() == jrep.needs_recovery() != {}
        jdom, jrev = jfix.recover(jrep, clean_copy=jclean.__getitem__,
                                  response=JResponse.PEER_COPY,
                                  strikes=jstrikes, retirement=jret,
                                  retire_after=2)
        tdom, trev = tfix.recover(trep, clean_copy=tclean.__getitem__,
                                  response=Response.PEER_COPY,
                                  strikes=tstrikes, retirement=tret,
                                  retire_after=2)
        assert trev == jrev and tstrikes == jstrikes
        actions += [e["action"] for e in trev]
        for e in trev:
            got = state_to_numpy({"x": tdom.leaf(e["path"])})["x"]
            want = np.asarray(jdom.leaf(e["path"]))
            assert got.tobytes() == want.tobytes()
            assert got.tobytes() == state_to_numpy(
                {"x": tclean[e["path"]]})["x"].tobytes()
        jdom, tdom = jdom.reassert_hard(), tdom.reassert_hard()
    assert "peer_copy" in actions and "peer_copy+retire" in actions
    assert tret.blocks == jret.blocks and tret.count() >= 1
    assert not tdom.hard_errors and not jdom.hard_errors


def test_strike_then_recover_restores_bits_and_spares_clean_copies(params):
    """A params strike and a KV-pool strike, each detected by parity and
    recovered from the peer: the payload regains its original bits, and
    neither the engine's clean parameter copy nor the peer's KV image
    moves, even when the restored pools are then written in place."""
    eng = OnlineEngine(CFG, params, slots=2, page_size=8, max_prompt_len=8,
                       max_new_cap=8, policy=DESIGN_POINTS["detect_recover"](),
                       kv_tier=Tier.PARITY_R, peer_recovery=True)
    clean = {k: v.clone() for k, v in eng._clean.items()}
    gen = torch.Generator().manual_seed(0)
    eng.cache.pool_k.copy_(torch.randn(eng.cache.pool_k.shape,
                                       generator=gen))
    eng.cache.pool_v.copy_(torch.randn(eng.cache.pool_v.shape,
                                       generator=gen))
    eng._refresh_kv()
    peer = {k: v.clone() for k, v in eng._kv_peer.items()}
    pools = (eng.cache.pool_k.clone(), eng.cache.pool_v.clone())
    counters = SLOCounters()
    plan = InjectionPlan(np.array([3, 70], np.int32),
                         np.array([62, 14], np.int32), False)
    path = "blocks/attn/wq"
    eng.param_domain = eng.param_domain.apply_plan(path, plan)
    assert not torch.equal(eng.param_domain.leaf(path), params["blocks"]
                           ["attn"]["wq"])
    eng._scrub_params(counters)
    assert counters.peer_recovery_events == 1
    for s in eng.param_domain.spec.leaves:
        assert torch.equal(eng.param_domain.leaf(s.path).view(torch.int16),
                           clean[s.path].view(torch.int16)), s.path
    eng.kv_domain = eng.kv_domain.apply_plan("kv_cache/k", plan)
    eng._adopt_kv()
    assert not torch.equal(eng.cache.pool_k, pools[0])
    eng._scrub_kv(counters)
    assert counters.kv_detected == 2 and counters.peer_recovery_events == 2
    assert torch.equal(eng.cache.pool_k, pools[0])
    assert torch.equal(eng.cache.pool_v, pools[1])
    eng.cache.pool_k.add_(1)         # a decode step's in-place write
    for k, v in eng._kv_peer.items():
        assert torch.equal(v, peer[k]), k
    for k, v in eng._clean.items():
        assert torch.equal(v.view(torch.int16),
                           clean[k].view(torch.int16)), k


# ------------------------------------------------------------------- CLI
DRY = ["--dry-run", "--requests", "9", "--storm-errors", "100", "--policy",
       "detect_recover", "--kv-tier", "parity_r", "--process", "bursty",
       "--peer-recovery"]


def test_serve_online_dry_run_prints_the_reference_text(capsys):
    assert jserve_online.main(DRY) == 0
    want = capsys.readouterr().out
    assert serve_online.main(DRY + ["--device", CPU]) == 0
    assert capsys.readouterr().out == want
    assert "9 requests" in want and "parity_r" in want
    ap = serve_online.build_parser()
    assert ap.parse_args([]).tiny is True
    assert ap.parse_args(["--no-tiny"]).tiny is False


def test_serve_online_json_equals_reference(tmp_path, monkeypatch, capsys):
    """A tiny storm run of the CLI writes the reference's JSON, the
    reference's parameters carried across; nothing lands anywhere but the
    given path."""
    jcfg = jget_tiny("llama3-8b")
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    p = state_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    monkeypatch.setattr(serve_online, "init_params",
                        lambda cfg, seed, device: p)
    args = ["--requests", "8", "--rate", "40", "--seed", "3", "--slots",
            "2", "--policy", "detect_recover", "--kv-tier", "parity_r",
            "--storm-errors", "60", "--scrub-every", "4"]
    assert jserve_online.main(args + ["--json", str(tmp_path / "j.json")]) \
        == 0
    assert serve_online.main(args + ["--device", CPU, "--json",
                                     str(tmp_path / "t.json")]) == 0
    out = capsys.readouterr().out
    assert f"wrote {tmp_path / 't.json'}" in out
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert got == want and got["completed"] == 8
    assert sorted(x.name for x in tmp_path.iterdir()) == ["j.json",
                                                          "t.json"]


def test_metrics_equal_reference():
    """``build_report``, its summary, ``percentile`` and
    ``incorrect_rate`` over the same completions and counters."""
    from repro.serve import metrics as jmetrics
    from repro.serve.scheduler import CompletedRequest as JCompleted
    from repro_torch.serve import metrics
    from repro_torch.serve.scheduler import CompletedRequest
    reports = []
    for Req, Done, mod in ((JRequest, JCompleted, jmetrics),
                           (Request, CompletedRequest, metrics)):
        rng = np.random.default_rng(0)
        done = []
        for i in range(9):
            t0 = float(rng.uniform(0, 1))
            n = int(rng.integers(1, 6))
            done.append(Done(req=Req(rid=i, arrival=t0 / 2,
                                     prompt=np.zeros(4, np.int32),
                                     max_new=n),
                             tokens=list(range(n)), t_admitted=t0,
                             t_first_token=t0 + 0.01,
                             t_done=t0 + 0.01 + 0.02 * n))
        counters = mod.SLOCounters()
        counters.charge_recoveries(3)
        counters.charge_peer_recoveries(2)
        counters.charge_crash()
        reports.append(mod.build_report(
            done, n_requests=10, shed=1, elapsed=2.5, counters=counters,
            peak_active=3, peak_queue=4))
    want, got = reports
    assert got.to_dict() == want.to_dict() and got.summary() == \
        want.summary()
    assert np.isnan(metrics.percentile([], 50))
    maps = ({1: [2], 2: [3]}, {1: [2], 2: [4]})
    assert incorrect_rate(*maps) == jmetrics.incorrect_rate(*maps) == 0.5
    assert incorrect_rate({}, {}) == 0.0

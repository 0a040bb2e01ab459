"""DeepSeek-V2's multi-head latent attention (MLA) in the port, on the CPU
at tiny deepseek-v2-lite (one dense layer, two MoE layers), against the
benchmark's plain float32 reference (``hrmbench/reference/mla.py``,
loaded by path: the one copy the card's comparison runs too): YaRN,
``forward``, the contiguous and the paged latent decode, the
un-renormalised gates and the dense layer 0, the benchmark's layout of the
published model, the HRM verbs over the latent pool, the engine's run and
its spans and counters. The reference decompresses every position; the
port's decode attends the latent with W_UK absorbed into the query. The
engine's one decode graph (``serve/decode_graph.py``) around the one
``paged_decode_step`` is held here over both caches: the latent pool and,
at tiny deepseek-moe-16b, the ``k`` and ``v`` pools.

Tolerances, in float32 compute against the float32 reference: logits
within 1e-4 x max|logit| (the two sum products in other orders, and the
absorbed decode multiplies W_UK before the latent, not after); a layer's
output within 1e-5 x max|y| (one layer's rounding). The same path
computed in bfloat16 (the configuration's published compute dtype) misses
the logit tolerance by two orders of magnitude, which each of those tests
asserts. YaRN's frequencies, in float32, within 1e-6 relative of the
formula in float64. Tokens, counters and bits are compared exactly.
"""
import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs import (PORT_ARCHS, get_config, get_tiny,
                                 list_archs)
from repro_torch.core import MemoryDomain, Tier, tree
from repro_torch.core.policy import classify_path
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, mla)
from repro_torch.models.common import yarn_freqs, yarn_mscale
from repro_torch.models.mlp import _route, mlp_apply, moe_apply
from repro_torch.models.transformer import (paged_decode_logits,
                                            paged_decode_step, prefill_write)
from repro_torch.serve import OnlineEngine, PagedKVCache, Request
from repro_torch.serve.engine import kv_policy
from repro_torch.serve.metrics import SLOCounters
from repro_torch.serve.router import RequestRouter

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:              # the benchmark's package
    sys.path.insert(0, str(ROOT))
from hrmbench import mla as bench_mla  # noqa: E402

CPU = torch.device("cpu")
ARCH = "deepseek-v2-lite"
CFG = get_tiny(ARCH).replace(compute_dtype="float32")
LOGIT_TOL = 1e-4
LAYER_TOL = 1e-5


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("hrmbench/reference/mla.py", "mla_reference")


def _hf(cfg) -> dict:
    """``cfg`` under the published config.json's keys, as the benchmark's
    configuration file holds them."""
    c = json.loads((ROOT / "hrmbench/configs/deepseek-v2-lite.json")
                   .read_text())
    c.update(name=cfg.name, num_hidden_layers=cfg.n_layers,
             hidden_size=cfg.d_model, num_attention_heads=cfg.n_heads,
             num_key_value_heads=cfg.n_kv_heads,
             intermediate_size=cfg.d_ff, vocab_size=cfg.vocab_size,
             kv_lora_rank=cfg.kv_lora_rank,
             qk_nope_head_dim=cfg.qk_nope_head_dim,
             qk_rope_head_dim=cfg.qk_rope_head_dim,
             v_head_dim=cfg.v_head_dim,
             first_k_dense_replace=cfg.n_dense_layers,
             n_routed_experts=cfg.moe.n_experts,
             num_experts_per_tok=cfg.moe.top_k,
             moe_intermediate_size=cfg.moe.d_expert,
             n_shared_experts=cfg.moe.n_shared,
             capacity_factor=cfg.moe.capacity_factor,
             norm_topk_prob=cfg.norm_topk_prob,
             param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype)
    return c


C = _hf(CFG)


def _weights(seed: int = 11):
    return bench_mla.make(C, seed, CPU)


def _tokens(n: int, seed: int = 5) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, CFG.vocab_size, n, dtype=np.int64))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max() / b.abs().max())


# ----------------------------------------------------------- configuration
def test_config_is_published_and_listed_apart():
    cfg = get_config(ARCH)
    assert ARCH in PORT_ARCHS and ARCH not in list_archs()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
            cfg.vocab_size) == (27, 2048, 16, 10944, 102400)
    assert (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim, cfg.latent_dim) == (512, 128, 64, 128, 576)
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert,
            cfg.moe.n_shared) == (64, 6, 1408, 2)
    assert cfg.n_dense_layers == 1 and not cfg.norm_topk_prob
    # the benchmark's file builds the same configuration, at 7 layers
    c = json.loads((ROOT / "hrmbench/configs/deepseek-v2-lite.json")
                   .read_text())
    assert bench_mla.port_config(c) == cfg.replace(n_layers=7)
    assert bench_mla.port_config(C) == CFG
    n = sum(t.numel() for t in tree.leaves(init_params(cfg,
                                                       device="meta")))
    assert round(n / 1e9, 2) == 15.71


def test_yarn_frequencies_and_scale():
    cfg = get_config(ARCH)
    dim, theta = 64, 10000.0

    def dim_of(r):
        return dim * math.log(4096 / (2 * math.pi * r)) / (2 * math.log(
            theta))
    low, high = math.floor(dim_of(32)), math.ceil(dim_of(1))
    assert (low, high) == (10, 23)
    want = []
    for i in range(dim // 2):
        extra = theta ** (-2 * i / dim)
        keep = 1 - min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(extra / 40 * (1 - keep) + extra * keep)
    got = yarn_freqs(dim, theta, 40.0, 4096, 32.0, 1.0)
    torch.testing.assert_close(got.double(), torch.tensor(want,
                                                          dtype=torch.float64),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(REF.yarn_freqs(_hf(cfg)), got, rtol=1e-6,
                               atol=0)
    assert got[low] == pytest.approx(theta ** (-2 * low / dim), rel=1e-6)
    assert got[high] == pytest.approx(theta ** (-2 * high / dim) / 40,
                                      rel=1e-6)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert yarn_mscale(40.0, 0.707) == pytest.approx(m) \
        and round(m, 4) == 1.2608
    assert mla.scale(cfg) == pytest.approx(192 ** -0.5 * m * m)
    assert REF.softmax_scale(_hf(cfg)) == pytest.approx(mla.scale(cfg))


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_equals_reference(dtype):
    w = _weights()
    toks = torch.stack([_tokens(24, 1), _tokens(24, 2)])
    got, _, cache = forward(w, {"tokens": toks}, CFG.replace(
        compute_dtype=dtype), return_cache=True)
    assert cache["latent"].shape == (3, 2, 24, CFG.latent_dim)
    err = max(_rel(got[b], REF.logits(w, C, toks[b])) for b in range(2))
    if dtype == "float32":
        assert err < LOGIT_TOL
    else:                         # the control: bfloat16 misses it
        assert err > 100 * LOGIT_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_contiguous_decode_equals_reference(dtype):
    cfg = CFG.replace(compute_dtype=dtype)
    w = _weights()
    seq = _tokens(20, 3)
    ref = REF.logits(w, C, seq)
    _, _, pre = forward(w, {"tokens": seq[None, :11]}, cfg,
                        return_cache=True)
    cache = init_cache(cfg, 1, 24, device=CPU)
    cache["latent"][:, :, :11] = pre["latent"]
    err = 0.0
    for t in range(11, 20 if dtype == "float32" else 13):  # control: 2
        logits, cache = decode_step(w, seq[t:t + 1], t, cache, cfg)
        err = max(err, _rel(logits[0], ref[t]))
    assert err < LOGIT_TOL if dtype == "float32" else err > 100 * LOGIT_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_latent_decode_equals_reference(dtype):
    """Three slots prefilled to 5, 11 and 16 positions in 4-position
    pages, then 9 absorbed decode steps each over the gathered pages:
    slots of different lengths, crossing page boundaries, against the
    reference's full forward of each sequence."""
    cfg = CFG.replace(compute_dtype=dtype)
    w = _weights()
    page, steps, lens = 4, 9, (5, 11, 16)
    seqs = [_tokens(n + steps, 10 + i) for i, n in enumerate(lens)]
    refs = [REF.logits(w, C, s) for s in seqs]
    cache = PagedKVCache(cfg, n_pages=40, page_size=page, slots=3,
                         max_pages_per_slot=8, device=CPU)
    for slot, n in enumerate(lens):
        pages = cache.alloc(slot, n + steps)
        n_pp = cache.pages_needed(n)
        toks = torch.zeros(1, n_pp * page, dtype=torch.long)
        toks[0, :n] = seqs[slot][:n]
        first, ok = prefill_write(
            w, cache.pools, toks, n, torch.as_tensor(
                pages[:n_pp], dtype=torch.long), cfg, page)
        assert bool(ok)
    table = cache.device_table()
    err = 0.0
    for k in range(steps if dtype == "float32" else 2):    # control: 2
        pos = torch.tensor([n + k for n in lens])
        tokens = torch.stack([s[p] for s, p in zip(seqs, pos.tolist())])
        logits = paged_decode_logits(w, cache.pools, table, tokens, pos,
                                     cfg, page)
        err = max(err, max(_rel(logits[i], refs[i][int(pos[i])])
                           for i in range(3)))
    assert err < LOGIT_TOL if dtype == "float32" else err > 100 * LOGIT_TOL
    if dtype == "bfloat16":
        return
    # the pages hold each slot's latents, as the contiguous forward's
    _, _, full = forward(w, {"tokens": seqs[1][None]}, cfg,
                         return_cache=True)
    (lat,) = cache.contiguous_view(1, lens[1] + steps)
    assert _rel(lat[:, 0], full["latent"][:, 0]) < LAYER_TOL * 10


# ------------------------------------------------------- gates, layer 0
def test_gates_not_renormalised_and_the_dense_layer():
    w = _weights()
    x = torch.randn(30, CFG.d_model, generator=torch.Generator()
                    .manual_seed(4))
    moe_w = {k: (v[0] if torch.is_tensor(v) else {kk: vv[0] for kk, vv in
                                                   v.items()})
             for k, v in w["blocks"]["moe"].items()}
    gates, topw, tope, _ = _route(moe_w, x, CFG)
    torch.testing.assert_close(topw, gates.gather(1, tope), rtol=0, atol=0)
    assert float(topw.sum(-1).max()) < 1 - 1e-3
    _, renorm, _, _ = _route(moe_w, x, CFG.replace(norm_topk_prob=True))
    torch.testing.assert_close(renorm.sum(-1), torch.ones(30))
    got, _ = moe_apply(moe_w, x[None], CFG)
    ref = REF._moe(w["blocks"]["moe"], 0, x, C, REF.FLOAT32)
    assert _rel(got[0], ref) < LAYER_TOL
    other, _ = moe_apply(moe_w, x[None], CFG.replace(norm_topk_prob=True))
    assert _rel(other[0], ref) > 1e-2
    mw = {k: v[0] for k, v in w["dense_blocks"]["mlp"].items()}
    assert mw["wi"].shape == (CFG.d_model, CFG.d_ff)
    ref = REF._swiglu(x, mw["wi"], mw["wg"], mw["wo"], REF.FLOAT32)
    assert _rel(mlp_apply(mw, x, CFG), ref) < LAYER_TOL


# --------------------------------------------------------------- layout
def test_benchmark_layout_is_the_ports_tree_with_regions():
    c = json.loads((ROOT / "hrmbench/configs/deepseek-v2-lite.json")
                   .read_text())
    cfg = bench_mla.port_config(c)
    bench_mla.check_layout(cfg, c)             # raises on any difference
    bench_mla.check_layout(CFG, C)
    n = sum(math.prod(s) for _, s, _, _ in bench_mla.layout(c))
    assert round(n / 1e9, 2) == 4.01
    want = {"dense_blocks/attn/wkv_a": "params/attn",
            "blocks/attn/wkv_b": "params/attn",
            "blocks/attn/kv_norm": "params/attn",
            "dense_blocks/mlp/wi": "params/mlp",
            "dense_blocks/norm1": "params/norm",
            "blocks/moe/wo": "params/experts",
            "blocks/moe/shared/wg": "params/experts"}
    for path, region in want.items():
        assert classify_path(tuple(path.split("/"))) == region, path
    pool = torch.zeros(3, 4, 2, 8)
    dom = MemoryDomain.protect({"kv_cache": {"latent": pool}},
                               kv_policy(Tier.PARITY_R))
    assert dom.paths() == ["kv_cache/latent"]
    assert dom.region_of("kv_cache/latent") == "kv_cache"
    assert dom.tier_of("kv_cache/latent") is Tier.PARITY_R


# ------------------------------------------------------------- serving
def _requests(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, arrival=0.01 * i,
                    prompt=rng.integers(0, CFG.vocab_size, int(p),
                                        dtype=np.int32), max_new=int(m))
            for i, (p, m) in enumerate(zip(rng.integers(3, 15, n),
                                           rng.integers(2, 7, n)))]


def _engine(kv_tier=Tier.PARITY_R, **kw):
    return OnlineEngine(CFG, _weights(), slots=3, page_size=4,
                        max_prompt_len=16, max_new_cap=8, kv_tier=kv_tier,
                        debug_invariants=True, **kw)


def test_engine_serves_the_reference_s_tokens():
    eng = _engine()
    assert set(eng.cache.pools) == {"latent"}
    assert eng.kv_domain.paths() == ["kv_cache/latent"]
    reqs = _requests()
    report, responses = eng.run(reqs)
    assert len(responses) == len(reqs)
    w = _weights()
    for r in reqs:
        toks = responses[r.rid]
        assert len(toks) == r.max_new
        seq = torch.as_tensor(np.concatenate([r.prompt, toks[:-1]]))
        ref = REF.logits(w, C, seq, last=len(toks))
        gap = ref.max(-1).values - ref.gather(
            1, torch.as_tensor(toks)[:, None])[:, 0]
        assert float(gap.max()) <= LOGIT_TOL * float(ref.abs().max())
    eng.cache.check_invariants()


@pytest.mark.parametrize("tier", [Tier.PARITY_R, Tier.SECDED])
def test_struck_latent_word_is_detected_or_corrected(tier):
    eng = _engine(kv_tier=tier)
    eng.run(_requests(4, seed=1))
    pool = eng.cache.pools["latent"]
    clean = pool.clone()
    raw = pool.view(-1).view(torch.int32)
    word = int(torch.nonzero(raw).reshape(-1)[7])   # a written value
    eng.kv_domain = eng.kv_domain.apply_plan(
        "kv_cache/latent", _plan(word // 2, 5 + 32 * (word % 2)))
    eng._adopt_kv()
    assert not torch.equal(eng.cache.pools["latent"], clean)
    got = SLOCounters()
    eng._scrub_kv(got)
    if tier is Tier.PARITY_R:
        assert (got.kv_detected, got.kv_corrected) == (1, 0)
    else:
        assert (got.kv_detected, got.kv_corrected) == (0, 1)
        assert torch.equal(eng.cache.pools["latent"].view(torch.int32),
                           clean.view(torch.int32))


def _plan(word: int, bit: int):
    from repro_torch.core.errormodel import InjectionPlan
    return InjectionPlan(np.array([word], np.int32),
                         np.array([bit], np.int32), False)


def test_peer_copy_and_crash_reset_over_the_latent_pool():
    eng = _engine(peer_recovery=True)
    eng.run(_requests(4, seed=2))
    assert set(eng._kv_peer) == {"kv_cache/latent"}
    pool = eng.cache.pools["latent"]
    word = int(torch.nonzero(pool.view(-1).view(torch.int32))
               .reshape(-1)[3])
    eng.kv_domain = eng.kv_domain.apply_plan("kv_cache/latent",
                                             _plan(word // 2, 3))
    eng._adopt_kv()
    got = SLOCounters()
    eng._scrub_kv(got)
    assert (got.kv_detected, got.peer_recovery_events) == (1, 1)
    assert torch.equal(eng.cache.pools["latent"],
                       eng._kv_peer["kv_cache/latent"])
    eng._crash_reset(RequestRouter([]), got)
    assert not eng.cache.pools["latent"].any()
    assert eng.kv_domain.leaf("kv_cache/latent") is \
        eng.cache.pools["latent"]
    with pytest.raises(KeyError):
        eng.cache.adopt_pools({"k": pool, "v": pool})


def test_spans_and_counters_of_the_latent_decode():
    eng = _engine(kv_tier=Tier.NONE)
    reqs = _requests(5, seed=3)
    with telemetry.recording():
        eng.run(reqs)
    recs = telemetry.records()
    names = {s.name for s in recs}
    assert {"mla.prefill", "mla.decode"} <= names
    for s in recs:
        if s.name.startswith("mla."):
            assert recs[s.parent].name == "layer.attn"
    c = telemetry.summary()["counters"]
    steps = telemetry.summary()["spans"]["engine.decode"]["count"]
    # a request's decode steps are at positions p .. p + max_new - 2
    assert c["mla_positions_attended"] == sum(
        sum(r.prompt_len + k + 1 for k in range(r.max_new - 1))
        for r in reqs)
    assert c["mla_positions_gathered"] == steps * 3 * eng.cache \
        .max_pages_per_slot * 4
    read = _load("hrmbench/metrics/latent_read_use.longdoc.py",
                 "latent_read_use_metric").read
    assert read({}) == pytest.approx(100 * c["mla_positions_attended"]
                                     / c["mla_positions_gathered"])


# ------------------------------------------------------ the decode graph
MHA = get_tiny("deepseek-moe-16b")
# each layout's case: the configuration, the slots' prefilled lengths (of
# three slots; a third left out is idle, its table row all null page),
# and the attention leaves a scrub rebuilds and a strike hits
GRAPH_CASES = {"kv": (MHA, (5, 11), "wq", "wk"),
               "latent": (CFG, (5, 11, 16), "wkv_b", "wkv_a")}


def _decode_inputs(kind: str, cfg, device, page=4):
    """A paged cache of ``GRAPH_CASES[kind]`` on ``device`` with its slots
    prefilled, and the weights: the benchmark's for the latent cache,
    ``init_params``' for the k/v one."""
    lens = GRAPH_CASES[kind][1]
    if kind == "latent":
        w = bench_mla.make(dict(C, param_dtype=cfg.param_dtype,
                                compute_dtype=cfg.compute_dtype), 11, device)

        def prompt(slot, n):
            return _tokens(n, 10 + slot)
    else:
        w = init_params(cfg, seed=3, device=device)
        rng = np.random.default_rng(20)

        def prompt(slot, n):
            return torch.as_tensor(rng.integers(0, cfg.vocab_size, n))
    cache = PagedKVCache(cfg, n_pages=40, page_size=page, slots=3,
                         max_pages_per_slot=8, device=device)
    for slot, n in enumerate(lens):
        pages = cache.alloc(slot, n + 9)
        n_pp = cache.pages_needed(n)
        toks = torch.zeros(1, n_pp * page, dtype=torch.long, device=device)
        toks[0, :n] = prompt(slot, n).to(device)
        prefill_write(w, cache.pools, toks, n,
                      torch.as_tensor(pages[:n_pp], device=device), cfg,
                      page)
    return w, cache


def _step_inputs(kind: str, k: int, device):
    """Step ``k``'s tokens and positions: each held slot one position on,
    an idle slot token 0 at position 0 (into the null page)."""
    lens = GRAPH_CASES[kind][1]
    idle = [0] * (3 - len(lens))
    return (torch.tensor([3 + k, 7, 9][:len(lens)] + idle, device=device),
            torch.tensor([n + k for n in lens] + idle, device=device))


@pytest.mark.parametrize("kind", GRAPH_CASES)
def test_decode_graph_runs_eagerly_on_the_cpu(kind):
    from repro_torch.serve.decode_graph import DecodeGraph
    cfg = GRAPH_CASES[kind][0]
    w, cache = _decode_inputs(kind, cfg, CPU)
    pools = cache.pools
    twins = {name: pool.clone() for name, pool in pools.items()}
    graph = DecodeGraph(paged_decode_step)
    table = cache.device_table()
    for k in range(3):
        tokens, pos = _step_inputs(kind, k, CPU)
        got = graph(w, pools, table, tokens, pos, cfg, 4)
        want = paged_decode_step(w, twins, table, tokens, pos, cfg, 4)
        assert torch.equal(got[0], want[0]) and bool(got[1])
    assert all(torch.equal(pools[name], twins[name]) for name in pools)
    assert graph._graph is None


@pytest.mark.parametrize("kind", GRAPH_CASES)
def test_decode_graph_key_follows_the_leaves_by_address(kind):
    """A leaf or a pool written in place keeps the key (the graph reads it
    there); a leaf or any one pool replaced by another tensor makes a new
    one."""
    from repro_torch.serve.decode_graph import key_of
    cfg, _, rebuilt, _ = GRAPH_CASES[kind]
    w, cache = _decode_inputs(kind, cfg, CPU)
    pools, table = cache.pools, cache.device_table()
    attn = w["blocks"]["attn"]
    key = key_of(w, pools, table)
    attn[rebuilt].mul_(1.5)
    for pool in pools.values():
        pool[:, 1:].mul_(-1)
    assert key_of(w, pools, table) == key
    for name, pool in pools.items():
        assert key_of(w, dict(pools, **{name: pool.clone()}), table) != key
    attn[rebuilt] = attn[rebuilt].clone()
    assert key_of(w, pools, table) != key


@pytest.mark.parametrize("cfg,name", [(MHA, "paged_decode_step"),
                                      (CFG, "latent_decode_step")],
                         ids=["kv", "latent"])
def test_engine_builds_one_decode_graph_around_its_cache_s_step(
        cfg, name, monkeypatch):
    """The engine wraps the step it finds under its layout's name, the one
    the benchmark's fault plants patch."""
    from repro_torch.serve import engine
    from repro_torch.serve.decode_graph import DecodeGraph

    def step(*a):
        return paged_decode_step(*a)
    monkeypatch.setattr(engine, name, step)
    w = init_params(cfg, seed=0, device=CPU) if cfg is MHA else _weights()
    eng = OnlineEngine(cfg, w, slots=2, page_size=4, max_prompt_len=8,
                       max_new_cap=4)
    assert isinstance(eng._decode, DecodeGraph)
    assert eng._decode._step is step


@pytest.mark.card
@pytest.mark.parametrize("kind", GRAPH_CASES)
def test_decode_graph_replays_equal_the_eager_step_on_the_card(kind):
    """``paged_decode_step`` eagerly against the graph's over the same
    inputs, in bfloat16, tokens and every pool bit for bit (the null page
    too: an idle slot writes it): the warm-up, capture and replays; a
    parameter leaf replaced (a scrub's rebuilt leaf: captured again); a
    word struck in place (read by the replay as struck); one pool adopted
    alone (captured again)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.serve.decode_graph import DecodeGraph
    dev = torch.device("cuda")
    cfg, _, rebuilt, struck = GRAPH_CASES[kind]
    cfg = cfg.replace(compute_dtype="bfloat16", param_dtype="bfloat16")
    w, cache = _decode_inputs(kind, cfg, dev)
    pools = dict(cache.pools)
    twins = {name: pool.clone() for name, pool in pools.items()}
    graph = DecodeGraph(paged_decode_step)
    table = cache.device_table()
    attn = w["blocks"]["attn"]
    with telemetry.recording():
        for k in range(8):
            if k == 4:                      # a scrub's rebuilt leaf
                attn[rebuilt] = attn[rebuilt] * 1.5
            if k == 5:                      # a word struck in place
                attn[struck].view(-1)[:64].mul_(-3)
            if k == 6:                      # the first pool adopted alone
                name = next(iter(pools))
                pools[name], twins[name] = (pools[name].clone(),
                                            twins[name].clone())
            tokens, pos = _step_inputs(kind, k, dev)
            got = graph(w, pools, table, tokens, pos, cfg, 4)
            want = paged_decode_step(w, twins, table, tokens, pos, cfg, 4)
            assert torch.equal(got[0], want[0]), k
            assert bool(got[1]) == bool(want[1]), k
            assert all(torch.equal(pools[n], twins[n]) for n in pools), k
    c = telemetry.summary()["counters"]
    assert c["decode_replays"] == 7             # every step but the first
    assert c["decode_captures"] == 3            # steps 1, 4 and 6


@pytest.mark.card
def test_engine_on_a_kv_cache_serves_as_its_eager_twin_on_the_card(
        monkeypatch):
    """``OnlineEngine`` on tiny deepseek-moe-16b in bfloat16 under
    ``detect_recover_l`` params and ``parity_r`` KV, with a storm and a
    scrub every 4 iterations: its tokens and counters equal those of the
    same engine whose decode graph is the eager step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import DESIGN_POINTS
    dev = torch.device("cuda")
    cfg = MHA.replace(compute_dtype="bfloat16", param_dtype="bfloat16")
    rng = np.random.default_rng(4)
    reqs = [Request(rid=i, arrival=0.01 * i,
                    prompt=rng.integers(0, cfg.vocab_size, int(p),
                                        dtype=np.int32), max_new=int(m))
            for i, (p, m) in enumerate(zip(rng.integers(3, 15, 8),
                                           rng.integers(2, 8, 8)))]

    def serve(eager: bool):
        eng = OnlineEngine(cfg, init_params(cfg, seed=3, device=dev),
                           slots=3, page_size=4, max_prompt_len=16,
                           max_new_cap=8,
                           policy=DESIGN_POINTS["detect_recover_l"](),
                           kv_tier=Tier.PARITY_R, scrub_every=4,
                           debug_invariants=True, seed=1)
        if eager:
            monkeypatch.setattr(eng, "_decode", paged_decode_step)
        with telemetry.recording():
            report, responses = eng.run(reqs, storm_errors=12)
        return report.counters, responses, telemetry.summary()["counters"]

    counters, responses, c = serve(eager=False)
    assert c["decode_captures"] >= 2 and c["decode_replays"] > 0
    want_counters, want_responses, _ = serve(eager=True)
    assert responses == want_responses
    assert counters == want_counters

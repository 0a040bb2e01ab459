"""The port's MoE family against the JAX reference on the CPU, at tiny
granite-moe-3b-a800m and tiny deepseek-moe-16b (shared experts): the
configs, the parameter trees, the grouped dispatch (``moe_apply``) against
the reference's and against the plain every-expert path, ``forward``,
``loss_fn`` and its gradients, ``decode_step``, ``serve_batch``, paged
decode, ``OnlineEngine.run``, a Fig. 2 campaign and the CLIs. The
reference's parameters are carried across through numpy; inputs come from
a numpy seed.

Tolerances, all in float32 compute: dispatch outputs within 1e-5 x
max|y|; logits, decode logits and caches within 1e-4 x max|value| (the
two frameworks sum products in other orders); decode against the port's
own teacher-forced ``forward`` within 5e-2, the reference's guard in
``tests/test_models.py``, at ``capacity_factor=16`` where no token is
dropped (the reference's test uses the same); the loss within 1e-5
relative and each gradient leaf within 1e-4 x its max|g|. Greedy tokens,
serve reports, SLO reports and campaign outcomes are compared exactly;
the reference runs its kernels in Pallas interpret mode, as its own tests
run them.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.characterize as jchar
from repro.configs import get_config as jget_config
from repro.configs import get_tiny as jget_tiny
from repro.core import Tier as JTier
from repro.core.policy import DESIGN_POINTS as JDESIGN_POINTS
from repro.core.policy import classify_path as jclassify_path
from repro.launch import serve_online as jserve_online
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import mlp as jmlp
from repro.models.transformer import init_cache as jinit_cache
from repro.models.transformer import loss_fn as jloss_fn
from repro.runtime.serve_loop import serve_batch as jserve_batch
from repro.serve import OnlineEngine as JOnlineEngine
from repro.serve import TrafficConfig as JTrafficConfig
from repro.serve import generate_trace as jgenerate_trace
from repro_torch.configs import get_config, get_tiny
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import (DESIGN_POINTS, HRMPolicy, MemoryDomain, Tier,
                              characterize, tree)
from repro_torch.core.policy import classify_path
from repro_torch.launch import serve, serve_online
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, mlp)
from repro_torch.models.transformer import paged_decode_logits, prefill_write
from repro_torch.runtime.serve_loop import serve_batch
from repro_torch.runtime.steps import _value_and_grad
from repro_torch.serve import (OnlineEngine, PagedKVCache, TrafficConfig,
                               generate_trace)

CPU = "cpu"
ARCHS = ("granite-moe-3b-a800m", "deepseek-moe-16b")
DISPATCH_REL = 1e-5
F32_REL = 1e-4
DECODE_ATOL = 5e-2
LOSS_RTOL, GRAD_REL = 1e-5, 1e-4
NO_DROP = 16.0                  # capacity_factor at which nothing drops


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _pair(arch: str, **kw):
    """(reference cfg, port cfg, reference params, port params), float32
    compute, the reference's seed-0 parameters carried across."""
    kw.setdefault("compute_dtype", "float32")
    jcfg, cfg = jget_tiny(arch), get_tiny(arch)
    if "capacity_factor" in kw:
        c = kw.pop("capacity_factor")
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                    capacity_factor=c))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=c))
    jcfg, cfg = jcfg.replace(**kw), cfg.replace(**kw)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, state_from_numpy(_np(jp), device=CPU)


def _tokens(vocab: int, shape, seed: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def _close(got: torch.Tensor, want, rel: float) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())
    return err


# ------------------------------------------------------ configs and trees
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ("config", "tiny"))
def test_config_equals_reference(arch, size):
    got = (get_config if size == "config" else get_tiny)(arch)
    want = (jget_config if size == "config" else jget_tiny)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("head_dim", "has_attention", "has_kv_cache", "is_decoder",
                 "sub_quadratic"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.moe.capacity_factor == 1.25
    assert got.moe.router_aux_weight == 0.01


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_equals_reference(arch):
    """Paths in sorted order, shapes, dtypes and HRM regions: the router
    float32, the experts (E, D, Fe) / (E, Fe, D) under params/experts."""
    cfg = get_tiny(arch)
    jp = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0),
                                             jget_tiny(arch)))
    want = [("/".join(k.key for k in path), leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jp)[0]]
    got = tree.flatten_with_path(init_params(cfg, seed=0, device=CPU))[0]
    assert [p for p, _ in want] == ["/".join(p) for p, _ in got]
    for (path, w), (tpath, t) in zip(want, got):
        assert tuple(t.shape) == w.shape and \
            str(t.dtype)[6:] == str(w.dtype), path
        assert classify_path(tpath) == jclassify_path(
            [jax.tree_util.DictKey(k) for k in tpath]), path
    regions = {classify_path(p) for p, _ in got}
    assert {"params/experts", "params/attn", "params/embed",
            "params/norm"} <= regions
    shared = [p for p, _ in got if "shared" in p]
    assert bool(shared) == bool(cfg.moe.n_shared)
    leaves = dict(("/".join(p), t) for p, t in got)
    assert leaves["blocks/moe/router"].dtype == torch.float32


def test_convert_carries_a_bf16_tree_with_its_float32_router():
    """``state_from_numpy`` carries granite's own bf16 parameters across
    unchanged: every leaf's dtype and bytes, the float32 router among
    bf16 experts included; ``state_to_numpy`` brings them back."""
    jp = _np(jinit_params(jax.random.PRNGKey(0),
                          jget_tiny(ARCHS[0]).replace(
                              param_dtype="bfloat16")))
    p = state_from_numpy(jp, device=CPU)
    assert p["blocks"]["moe"]["router"].dtype == torch.float32
    assert p["blocks"]["moe"]["wi"].dtype == torch.bfloat16
    back = state_to_numpy(p)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            jax.tree.leaves(back)):
        w = w.view(np.uint16) if w.dtype.name == "bfloat16" else w
        np.testing.assert_array_equal(g, w, err_msg=str(path))


# ------------------------------------------------------------ dispatch
def _moe_case(arch: str, capacity_factor: float, T: int = 96):
    jcfg, cfg, jp, p = _pair(arch, capacity_factor=capacity_factor)
    layer = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    x = np.random.default_rng(4).standard_normal(
        (2, T // 2, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, layer, state_from_numpy(_np(layer), device=CPU), x


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference_and_dense_oracle(arch):
    """At a no-drop capacity the grouped dispatch equals the plain path
    and the reference's; the aux loss equals the reference's."""
    jcfg, cfg, jl, tl, x = _moe_case(arch, NO_DROP)
    want, jaux = jmlp.moe_apply(jl, jnp.asarray(x), jcfg)
    got, aux = mlp.moe_apply(tl, torch.from_numpy(x), cfg)
    dense, daux = mlp.moe_apply_dense(tl, torch.from_numpy(x), cfg)
    jdense, _ = jmlp.moe_apply_dense(jl, jnp.asarray(x), jcfg)
    assert got.shape == x.shape and aux.dtype == torch.float32
    _close(got, want, DISPATCH_REL)
    _close(dense, jdense, DISPATCH_REL)
    assert float((got - dense).abs().max()) <= \
        DISPATCH_REL * float(dense.abs().max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert float(daux) == float(aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_overflow_drop_equals_reference(arch):
    """At capacity_factor 0.25 (capacity 8 for 96 tokens x top-2 over 8
    experts) tokens overflow; the port drops the same ones."""
    jcfg, cfg, jl, tl, x = _moe_case(arch, 0.25)
    T = x.shape[0] * x.shape[1]
    assert mlp._capacity(T, cfg.moe) == 8
    want, _ = jmlp.moe_apply(jl, jnp.asarray(x), jcfg)
    got, _ = mlp.moe_apply(tl, torch.from_numpy(x), cfg)
    dense, _ = mlp.moe_apply_dense(tl, torch.from_numpy(x), cfg)
    _close(got, want, DISPATCH_REL)
    # some tokens were dropped: the grouped path is not the plain one
    assert float((got - dense).abs().max()) > 1e-3


def test_route_breaks_ties_like_top_k():
    """All gates equal (a zero router): the top-k picks the lowest expert
    ids, as ``jax.lax.top_k`` does."""
    _, cfg, _, tl, x = _moe_case(ARCHS[0], NO_DROP)
    tl = dict(tl, router=torch.zeros_like(tl["router"]))
    _, topw, tope, _ = mlp._route(tl, torch.from_numpy(x[0]), cfg)
    jtopw, jtope = jax.lax.top_k(jnp.full((x.shape[1], 8), 0.125), 2)
    np.testing.assert_array_equal(tope.numpy(), np.asarray(jtope))
    np.testing.assert_array_equal(topw.numpy(), np.full(topw.shape, 0.5))


# ------------------------------------------------------ model entry points
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_cache_match_reference(arch):
    jcfg, cfg, jp, p = _pair(arch)
    toks = _tokens(cfg.vocab_size, (2, 40))
    want, jaux, jcache = jforward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                  return_cache=True)
    got, aux, cache = forward(p, {"tokens": torch.from_numpy(toks)}, cfg,
                              return_cache=True)
    _close(got, want, F32_REL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert sorted(cache) == sorted(jcache)
    for k in cache:
        assert tuple(cache[k].shape) == jcache[k].shape
        _close(cache[k], jcache[k], F32_REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_and_own_forward(arch):
    """Step by step over 24 tokens: the logits within 1e-4 x max|logit|
    of the reference's decode, and within 5e-2 of the port's own forward
    at a no-drop capacity."""
    jcfg, cfg, jp, p = _pair(arch, capacity_factor=NO_DROP)
    B, S = 2, 24
    toks = _tokens(cfg.vocab_size, (B, S), seed=5)
    jcache, cache = jinit_cache(jcfg, B, S), init_cache(cfg, B, S,
                                                        device=CPU)
    jstep = jax.jit(jdecode_step, static_argnums=(4,))
    logs = []
    for t in range(S):
        jlg, jcache = jstep(jp, jnp.asarray(toks[:, t]), jnp.int32(t),
                            jcache, jcfg)
        lg, cache = decode_step(p, torch.from_numpy(toks[:, t]), t, cache,
                                cfg)
        _close(lg, jlg, F32_REL)
        logs.append(lg)
    full = forward(p, {"tokens": torch.from_numpy(toks)}, cfg)[0]
    assert float((torch.stack(logs, 1) - full).abs().max()) < DECODE_ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``loss_fn`` (cross-entropy plus the router's aux loss) and every
    gradient leaf, the router's included."""
    jcfg, cfg, jp, p = _pair(arch)
    toks = _tokens(cfg.vocab_size, (2, 33), seed=6)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]),
          "labels": torch.from_numpy(toks[:, 1:])}
    (jl, jm), jg = jax.value_and_grad(
        lambda q: jloss_fn(q, jb, jcfg), has_aux=True)(jp)
    loss, grads = _value_and_grad(p, tb, cfg, "none")
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    want = {"/".join(k.key for k in path): g for path, g in
            jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = {"/".join(path): g for path, g in tree.flatten_with_path(grads)[0]}
    assert list(want) == list(got)
    for k in want:
        w = np.asarray(want[k])
        err = float(np.abs(got[k].numpy() - w).max())
        assert err <= GRAD_REL * np.abs(w).max(), (k, err)
    assert float(np.abs(np.asarray(want["blocks/moe/router"])).max()) > 0


# ----------------------------------------------------------------- serving
def _report(r):
    return (r.tokens_emitted, r.queries, r.scrub_corrected, r.scrub_detected,
            r.injected, r.sidecar_overhead)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("policy", (None, "detect_recover"))
def test_serve_batch_equals_reference(arch, policy):
    """4 prompts of 16 tokens, 12 new tokens, error rate 0.5, seed 9, a
    scrub every 4 tokens: the same tokens and counters."""
    jcfg, cfg, jp, p = _pair(arch)
    prompts = _tokens(cfg.vocab_size, (4, 16), seed=1)
    jpol = pol = None
    if policy is not None:
        jpol = dataclasses.replace(JDESIGN_POINTS[policy](), scrub_interval=4)
        pol = dataclasses.replace(DESIGN_POINTS[policy](), scrub_interval=4)
    want, jrep = jserve_batch(jcfg, jp, jnp.asarray(prompts, jnp.int32), 12,
                              policy=jpol, error_rate_per_token=0.5, seed=9)
    got, rep = serve_batch(cfg, p, torch.from_numpy(prompts), 12,
                           policy=pol, error_rate_per_token=0.5, seed=9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _report(rep) == _report(jrep) and rep.injected > 0


def test_paged_decode_equals_contiguous_decode():
    """At a no-drop capacity, three slots prefilled page by page and eight
    decode steps: the paged logits equal ``decode_step``'s on the
    contiguous cache bit for bit (the port's own bf16 compute)."""
    cfg = get_tiny(ARCHS[0]).replace(moe=dataclasses.replace(
        get_tiny(ARCHS[0]).moe, capacity_factor=NO_DROP))
    params = init_params(cfg, seed=0, device=CPU)
    b, s0, new, ps = 3, 8, 8, 8
    prompts = torch.from_numpy(_tokens(cfg.vocab_size, (b, s0), seed=3))
    cache = PagedKVCache(cfg, n_pages=2 * b + 1, page_size=ps, slots=b,
                         max_pages_per_slot=2, device=CPU)
    full = init_cache(cfg, b, s0 + new, device=CPU)
    tok = []
    for i in range(b):
        pages = torch.from_numpy(cache.alloc(i, s0 + new).astype(np.int64))
        first, ok = prefill_write(params, cache.pools,
                                  prompts[i:i + 1], s0, pages[:1], cfg, ps)
        logits, _, c = forward(params, {"tokens": prompts[i:i + 1]}, cfg,
                               return_cache=True)
        for k in ("k", "v"):
            full[k][:, i, :s0] = c[k][:, 0]
        assert bool(ok) and int(first) == int(logits[0, -1].argmax())
        tok.append(int(first))
    tok = torch.tensor(tok)
    table = cache.device_table()
    for t in range(new):
        want, full = decode_step(params, tok, s0 + t, full, cfg)
        got = paged_decode_logits(params, cache.pools, table, tok,
                                  torch.full((b,), s0 + t), cfg, ps)
        assert torch.equal(got, want), t
        tok = torch.argmax(want, dim=-1)


@pytest.mark.parametrize("storm", (0, 540))
def test_engine_run_equals_reference(storm):
    """``OnlineEngine.run`` on tiny granite under the model clock with
    ``benchmarks/serve_slo.py``'s trace and plane (detect_recover + KV
    parity_r, a scrub every 4 iterations) at the default capacity: the SLO
    report and every response equal the reference's."""
    jcfg, cfg, jp, p = _pair(ARCHS[0])
    traffic = dict(n_requests=40, rate=16.0, process="bursty", seed=7)
    jtrace = jgenerate_trace(JTrafficConfig(**traffic), jcfg.vocab_size)
    trace = generate_trace(TrafficConfig(**traffic), cfg.vocab_size)
    plane = dict(slots=4, page_size=8, seed=7, max_prompt_len=16,
                 max_new_cap=8, scrub_every=4)
    jeng = JOnlineEngine(jcfg, jp, **plane,
                         policy=JDESIGN_POINTS["detect_recover"](),
                         kv_tier=JTier("parity_r"))
    eng = OnlineEngine(cfg, p, **plane, debug_invariants=True,
                       policy=DESIGN_POINTS["detect_recover"](),
                       kv_tier=Tier("parity_r"))
    jrep, jresp = jeng.run(jtrace, storm_errors=storm)
    rep, resp = eng.run(trace, storm_errors=storm)
    assert rep.to_dict() == jrep.to_dict()
    assert resp == jresp
    assert rep.completed + rep.shed == len(trace)
    if storm:
        c = rep.counters
        assert c["injected_params"] + c["injected_kv"] == storm
        assert c["recovery_events"] > 0


# ------------------------------------------------------------ the campaign
def test_campaign_outcomes_equal_reference():
    """A Fig. 2 campaign on tiny granite (8 soft and 4 hard trials, the
    query the greedy tokens of a 2 x 32 batch): the same strikes and the
    same outcome, trial by trial; the experts region is struck."""
    jcfg, cfg, jp, p = _pair(ARCHS[0])
    toks = _tokens(cfg.vocab_size, (2, 32), seed=8)
    jev = jax.jit(lambda q: jchar.lm_eval_fn(
        jcfg, {"tokens": jnp.asarray(toks)}, jforward)(q)[0])
    ev = characterize.lm_eval_fn(cfg, {"tokens": torch.from_numpy(toks)},
                                 forward)
    ref, port = [], []
    run_trial = jchar._run_trial

    def record(domain, s, plan, *a, **k):
        ref.append((s.path, run_trial(domain, s, plan, *a, **k)))
        return ref[-1][1]

    for kinds, n in ((("soft",), 8), (("hard",), 4)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jchar, "_run_trial", record)
            jchar.run_campaign(lambda q: (jev(q), q), jp, n_trials=n, seed=3,
                               kinds=kinds)
        port += characterize.run_campaign(ev, p, n_trials=n, seed=3,
                                          kinds=kinds).trials
    assert [(path, o.value) for path, o in ref] == \
        [(path, o.value) for path, _, o in port]
    dom = MemoryDomain.protect(p, HRMPolicy("campaign/params", {}))
    assert "params/experts" in {dom.spec.by_path[path].region
                                for path, _, _ in port}


# -------------------------------------------------------------------- CLIs
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs(arch, capsys):
    assert serve.main(["--arch", arch, "--tiny", "--device", CPU,
                       "--policy", "detect_recover", "--error-rate", "0.5",
                       "--batch", "2", "--new-tokens", "6"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and lines[0].startswith("generated: [[")
    assert lines[1].startswith("tokens=12 corrected=")


def test_serve_online_cli_json_equals_reference(tmp_path, monkeypatch,
                                                capsys):
    """A tiny granite storm run of the CLI writes the reference's JSON,
    the reference's parameters carried across."""
    arch = ARCHS[0]
    jp = jinit_params(jax.random.PRNGKey(0), jget_tiny(arch))
    p = state_from_numpy(_np(jp), device=CPU)
    monkeypatch.setattr(serve_online, "init_params",
                        lambda cfg, seed, device: p)
    args = ["--arch", arch, "--requests", "8", "--rate", "40", "--seed", "3",
            "--slots", "2", "--policy", "detect_recover", "--kv-tier",
            "parity_r", "--storm-errors", "60", "--scrub-every", "4"]
    assert jserve_online.main(args + ["--json", str(tmp_path / "j.json")]) \
        == 0
    assert serve_online.main(args + ["--device", CPU, "--json",
                                     str(tmp_path / "t.json")]) == 0
    assert f"wrote {tmp_path / 't.json'}" in capsys.readouterr().out
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert got == want and got["completed"] == 8

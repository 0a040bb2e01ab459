"""The port's hybrid (Mamba2 + shared attention) and xLSTM families against
the JAX reference on the CPU, at tiny zamba2-2.7b and tiny xlstm-350m: the
configs, the parameter trees, the chunked GLA core against the
reference's and against the plain recurrence (padded and whole chunks),
the Mamba2 mixer and the mLSTM/sLSTM blocks (whole sequence and one token
at a time), ``forward``, ``loss_fn`` and its gradients, ``decode_step``,
``serve_batch``, a Fig. 2 campaign on tiny zamba2 and the serve CLI. The
reference's parameters are carried across through numpy; inputs come from
a numpy seed.

Tolerances, all in float32 compute: the GLA core and the mixers within
1e-5 x max|value| of the reference (1e-4 for the recurrent oracle, which
sums over time where the chunked form sums by chunk); logits, decode
logits and states within 1e-4 x max|value|; decode against the port's
own ``forward`` within 5e-2, the reference's guard in
``tests/test_models.py``; the loss within 1e-5 relative and each gradient
leaf within 1e-4 x its max|g|. zamba2's loss and gradients are held to the
reference's values: the reference's own "one SGD step at lr 0.5 lowers
the loss" check overshoots on tiny zamba2, which is not a numerical fault.
Greedy tokens, serve reports and campaign outcomes are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.characterize as jchar
from repro.configs import get_config as jget_config
from repro.configs import get_tiny as jget_tiny
from repro.core.policy import DESIGN_POINTS as JDESIGN_POINTS
from repro.core.policy import classify_path as jclassify_path
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import gla as jgla
from repro.models import init_params as jinit_params
from repro.models import mamba2 as jmamba2
from repro.models import xlstm as jxlstm
from repro.models.transformer import init_cache as jinit_cache
from repro.models.transformer import loss_fn as jloss_fn
from repro.runtime.serve_loop import serve_batch as jserve_batch
from repro_torch.configs import get_config, get_tiny
from repro_torch.convert import state_from_numpy
from repro_torch.core import (DESIGN_POINTS, HRMPolicy, MemoryDomain,
                              characterize, tree)
from repro_torch.core.policy import classify_path
from repro_torch.launch import serve
from repro_torch.models import (decode_step, forward, gla, init_cache,
                                init_params, mamba2, xlstm)
from repro_torch.models.transformer import paged_decode_logits
from repro_torch.runtime.serve_loop import serve_batch
from repro_torch.runtime.steps import _value_and_grad
from repro_torch.serve import OnlineEngine, PagedKVCache

CPU = "cpu"
ARCHS = ("zamba2-2.7b", "xlstm-350m")
CORE_REL, ORACLE_REL = 1e-5, 1e-4
F32_REL = 1e-4
DECODE_ATOL = 5e-2
LOSS_RTOL, GRAD_REL = 1e-5, 1e-4


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _pair(arch: str, **kw):
    """(reference cfg, port cfg, reference params, port params), float32
    compute, the reference's seed-0 parameters carried across."""
    kw.setdefault("compute_dtype", "float32")
    jcfg, cfg = jget_tiny(arch).replace(**kw), get_tiny(arch).replace(**kw)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, state_from_numpy(_np(jp), device=CPU)


def _tokens(vocab: int, shape, seed: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def _close(got: torch.Tensor, want, rel: float) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape
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
    assert got.sub_quadratic


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_equals_reference(arch):
    """Paths in sorted order (``A_log`` before ``conv_b``), shapes, dtypes
    and HRM regions: the mixers under params/ssm, zamba2's shared block's
    attention under params/attn, the stacked ``blocks_m`` (G, K-1, ...)."""
    jp = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0),
                                             jget_tiny(arch)))
    want = [("/".join(k.key for k in path), leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jp)[0]]
    got = tree.flatten_with_path(init_params(get_tiny(arch), seed=0,
                                             device=CPU))[0]
    assert [p for p, _ in want] == ["/".join(p) for p, _ in got]
    for (path, w), (tpath, t) in zip(want, got):
        assert tuple(t.shape) == w.shape and \
            str(t.dtype)[6:] == str(w.dtype), path
        assert classify_path(tpath) == jclassify_path(
            [jax.tree_util.DictKey(k) for k in tpath]), path
    regions = {"/".join(p): classify_path(p) for p, _ in got}
    assert "params/ssm" in regions.values()
    if arch == "zamba2-2.7b":
        assert regions["shared/attn/wq"] == "params/attn"
        assert regions["blocks/mamba/in_proj"] == "params/ssm"
    else:
        assert regions["blocks_m/mlstm/wq"] == "params/ssm"


def test_deterministic_initialisations_equal_reference():
    """The computed leaves (A_log, dt_bias, D_skip, the gate biases, the
    norms) equal the reference's exactly; the drawn ones have its scale."""
    for arch in ARCHS:
        jp = _np(jinit_params(jax.random.PRNGKey(0), jget_tiny(arch)))
        p = init_params(get_tiny(arch), seed=0, device=CPU)
        for (path, t), w in zip(tree.flatten_with_path(p)[0],
                                jax.tree.leaves(jp)):
            name = path[-1]
            if name in ("A_log", "dt_bias", "D_skip", "b_i", "b_f", "b",
                        "conv_b") or "norm" in name:
                np.testing.assert_array_equal(t.float().numpy(),
                                              w.astype(np.float32))
            elif name in ("conv_w", "r_rec"):
                ratio = float(t.float().std()) / float(w.std())
                assert 0.8 < ratio < 1.25, (path, ratio)


# ---------------------------------------------------------------- GLA core
def _gla_inputs(S: int, seed: int = 0, B: int = 2, H: int = 3, N: int = 8,
                P: int = 5):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, S, H, N)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, S, H, P)).astype(np.float32)
    log_f = -np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(
        np.float32)
    h0 = rng.standard_normal((B, H, N, P)).astype(np.float32)
    return q, k, v, log_f, h0


@pytest.mark.parametrize("S", (64, 50))
def test_chunked_gla_matches_reference_and_recurrence(S):
    """Whole chunks (64 = 4 x 16) and a padded tail (50): y and the final
    state equal the reference's, with and without an initial state, and
    the plain recurrence (the port's and the reference's)."""
    q, k, v, log_f, h0 = _gla_inputs(S)
    for init in (None, h0):
        want_y, want_h = jgla.chunked_gla(
            *map(jnp.asarray, (q, k, v, log_f)), 16,
            initial_state=None if init is None else jnp.asarray(init))
        y, h = gla.chunked_gla(*map(_t, (q, k, v, log_f)), 16,
                               initial_state=None if init is None
                               else _t(init))
        _close(y, want_y, CORE_REL)
        _close(h, want_h, CORE_REL)
    ry, rh = gla.gla_reference(*map(_t, (q, k, v, log_f)))
    jry, jrh = jgla.gla_reference(*map(jnp.asarray, (q, k, v, log_f)))
    _close(ry, jry, CORE_REL)
    _close(rh, jrh, CORE_REL)
    y, h = gla.chunked_gla(*map(_t, (q, k, v, log_f)), 16)
    assert float((y - ry).abs().max()) <= ORACLE_REL * float(ry.abs().max())
    assert float((h - rh).abs().max()) <= ORACLE_REL * float(rh.abs().max())


def test_chunked_gla_large_decay_is_finite():
    """Strong decays make the masked exponents overflow; the double where
    keeps them out, so nothing is NaN."""
    q, k, v, log_f, _ = _gla_inputs(32, seed=1)
    y, h = gla.chunked_gla(*map(_t, (q, k, v, log_f * 200.0)), 32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())


# ------------------------------------------------------------------ mixers
def _layer(jp, path, index=(0,)):
    sub = jp
    for k in path:
        sub = sub[k]
    sub = jax.tree.map(lambda a: a[index], sub)
    return sub, state_from_numpy(_np(sub), device=CPU)


def _x(cfg, S: int, seed: int = 3):
    return np.random.default_rng(seed).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)


def _hold_states(got, want):
    for g, w in zip(got, want):
        _close(g, w, CORE_REL)


def test_mamba_apply_and_decode_match_reference():
    """``mamba_apply`` over 40 tokens (a padded chunk), then 4 one-token
    ``mamba_decode`` steps from its state."""
    jcfg, cfg, jp, _ = _pair("zamba2-2.7b")
    jl, tl = _layer(jp, ("blocks", "mamba"))
    x = _x(cfg, 44)
    want, jst = jmamba2.mamba_apply(jl, jnp.asarray(x[:, :40]), jcfg)
    got, st = mamba2.mamba_apply(tl, _t(x[:, :40]), cfg)
    _close(got, want, CORE_REL)
    _hold_states(st, jst)
    for t in range(40, 44):
        want, jst = jmamba2.mamba_decode(jl, jnp.asarray(x[:, t:t + 1]), jst,
                                         jcfg)
        got, st = mamba2.mamba_decode(tl, _t(x[:, t:t + 1]), st, cfg)
        _close(got, want, CORE_REL)
        _hold_states(st, jst)
    z = mamba2.mamba_state_init(cfg, 2, CPU)
    jz = jmamba2.mamba_state_init(jcfg, 2)
    for a, b in zip(z, jz):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == \
            str(b.dtype)


def test_mlstm_and_slstm_match_reference():
    """The mLSTM and sLSTM blocks over 40 tokens, then 4 one-token decode
    steps from their states."""
    jcfg, cfg, jp, _ = _pair("xlstm-350m")
    jm, tm = _layer(jp, ("blocks_m", "mlstm"), (0, 0))
    js, ts = _layer(jp, ("blocks_s", "slstm"))
    x = _x(cfg, 44)
    for jblk, tblk, japply, apply, jdec, dec in (
            (jm, tm, jxlstm.mlstm_apply, xlstm.mlstm_apply,
             jxlstm.mlstm_decode, xlstm.mlstm_decode),
            (js, ts, jxlstm.slstm_apply, xlstm.slstm_apply,
             jxlstm.slstm_decode, xlstm.slstm_decode)):
        want, jst = japply(jblk, jnp.asarray(x[:, :40]), jcfg)
        got, st = apply(tblk, _t(x[:, :40]), cfg)
        _close(got, want, CORE_REL)
        _hold_states(st, jst)
        for t in range(40, 44):
            want, jst = jdec(jblk, jnp.asarray(x[:, t:t + 1]), jst, jcfg)
            got, st = dec(tblk, _t(x[:, t:t + 1]), st, cfg)
            _close(got, want, CORE_REL)
            _hold_states(st, jst)
    for a, b in zip(xlstm.mlstm_state_init(cfg, 2, CPU) +
                    xlstm.slstm_state_init(cfg, 2, CPU),
                    jxlstm.mlstm_state_init(jcfg, 2) +
                    jxlstm.slstm_state_init(jcfg, 2)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


# ------------------------------------------------------ model entry points
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_cache_match_reference(arch):
    """40 tokens (zamba2: one whole and one padded chunk of 32; xlstm: the
    same): logits, aux (0) and every cache leaf, recurrent states
    included."""
    jcfg, cfg, jp, p = _pair(arch)
    toks = _tokens(cfg.vocab_size, (2, 40))
    want, jaux, jcache = jforward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                  return_cache=True)
    got, aux, cache = forward(p, {"tokens": torch.from_numpy(toks)}, cfg,
                              return_cache=True)
    _close(got, want, F32_REL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))
    assert float(aux) == float(jaux) == 0.0
    assert sorted(cache) == sorted(jcache)
    for k in cache:
        _close(cache[k], jcache[k], F32_REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_and_own_forward(arch):
    """Step by step over 24 tokens from ``init_cache``: the logits within
    1e-4 x max|logit| of the reference's, the states after the last step
    the reference's, and the logits within 5e-2 of the port's forward."""
    jcfg, cfg, jp, p = _pair(arch)
    B, S = 2, 24
    toks = _tokens(cfg.vocab_size, (B, S), seed=5)
    jcache, cache = jinit_cache(jcfg, B, S), init_cache(cfg, B, S,
                                                        device=CPU)
    for k in cache:
        _close(cache[k], jcache[k], 0.0)
    jstep = jax.jit(jdecode_step, static_argnums=(4,))
    logs = []
    for t in range(S):
        jlg, jcache = jstep(jp, jnp.asarray(toks[:, t]), jnp.int32(t),
                            jcache, jcfg)
        lg, cache = decode_step(p, torch.from_numpy(toks[:, t]), t, cache,
                                cfg)
        _close(lg, jlg, F32_REL)
        logs.append(lg)
    for k in cache:
        _close(cache[k], jcache[k], F32_REL)
    full = forward(p, {"tokens": torch.from_numpy(toks)}, cfg)[0]
    assert float((torch.stack(logs, 1) - full).abs().max()) < DECODE_ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg, cfg, jp, p = _pair(arch)
    toks = _tokens(cfg.vocab_size, (2, 41), seed=6)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]),
          "labels": torch.from_numpy(toks[:, 1:])}
    (jl, _), jg = jax.value_and_grad(
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
        assert err <= GRAD_REL * np.abs(w).max() + 1e-12, (k, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch):
    _, cfg, _, p = _pair(arch)
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (2, 41), seed=7))
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    l0, g0 = _value_and_grad(p, b, cfg, "none")
    l1, g1 = _value_and_grad(p, b, cfg, "full")
    assert float(l0) == float(l1)
    for a, c in zip(tree.leaves(g0), tree.leaves(g1)):
        assert float((a - c).abs().max()) <= 1e-6 * float(a.abs().max())


# ----------------------------------------------------------------- serving
def _report(r):
    return (r.tokens_emitted, r.queries, r.scrub_corrected, r.scrub_detected,
            r.injected, r.sidecar_overhead)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("policy", (None, "detect_recover"))
def test_serve_batch_equals_reference(arch, policy):
    """4 prompts of 36 tokens (a padded chunk), 12 new tokens, error rate
    0.5, seed 9, a scrub every 4 tokens: the same tokens and counters;
    the recurrent states go from prefill to decode as they are."""
    jcfg, cfg, jp, p = _pair(arch)
    prompts = _tokens(cfg.vocab_size, (4, 36), seed=1)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_serving_raises_the_reference_error(arch):
    cfg = get_tiny(arch)
    p = init_params(cfg, seed=0, device=CPU)
    with pytest.raises(ValueError, match="attention-cache"):
        PagedKVCache(cfg, n_pages=4, page_size=8, slots=1,
                     max_pages_per_slot=1, device=CPU)
    with pytest.raises(ValueError, match="attention-cache"):
        OnlineEngine(cfg, p, slots=1, page_size=8, max_prompt_len=8,
                     max_new_cap=8)
    z = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="dense/moe/vlm"):
        paged_decode_logits(p, {}, z[:, None], z, z, cfg, 8)


def test_campaign_outcomes_equal_reference():
    """A Fig. 2 campaign on tiny zamba2 (8 soft and 4 hard trials, the
    query the greedy tokens of a 2 x 32 batch): the same strikes and the
    same outcome, trial by trial; the ssm region is struck."""
    jcfg, cfg, jp, p = _pair("zamba2-2.7b")
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
    assert "params/ssm" in {dom.spec.by_path[path].region
                            for path, _, _ in port}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs(arch, capsys):
    assert serve.main(["--arch", arch, "--tiny", "--device", CPU,
                       "--policy", "detect_recover", "--error-rate", "0.5",
                       "--batch", "2", "--new-tokens", "6"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and lines[0].startswith("generated: [[")
    assert lines[1].startswith("tokens=12 corrected=")

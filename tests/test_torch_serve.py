"""The port's serving path against the JAX reference on the CPU: the
one-token ``decode_step``, the prefill and serve steps, the batched serve
loop with HRM on the parameters, and the ``launch.serve`` CLI, on tiny
llama3-8b with the reference's parameters carried across through numpy.

Tolerances: decode logits agree with the reference's, and with the port's
own teacher-forced ``forward``, within 5e-2 (the bound of
``tests/test_models.py``: a few bf16 ulps at the logits' magnitude). The
serve loop runs with float32 compute, where the greedy tokens of the two
packages agree exactly; its strikes, scrubs and counters are exact
integers either way, and the reference runs its kernels in Pallas
interpret mode, as its own tests run them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as jget_tiny
from repro.core.policy import DESIGN_POINTS as JDESIGN_POINTS
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit_params
from repro.models.transformer import init_cache as jinit_cache
from repro.runtime.serve_loop import serve_batch as jserve_batch
from repro_torch.configs import get_tiny
from repro_torch.convert import state_from_numpy
from repro_torch.core import DESIGN_POINTS
from repro_torch.launch import serve
from repro_torch.models import decode_step, forward, init_cache
from repro_torch.runtime.serve_loop import serve_batch
from repro_torch.runtime.steps import make_prefill_step, make_serve_step

CPU = "cpu"
DECODE_ATOL = 5e-2
B, S = 2, 16


def _pair(**kw):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg = jget_tiny("llama3-8b").replace(**kw)
    cfg = get_tiny("llama3-8b").replace(**kw)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, state_from_numpy(jax.tree.map(np.asarray, jp),
                                           device=CPU)


def _tokens(vocab: int, shape, seed: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


@pytest.mark.parametrize("compute_dtype", ("bfloat16", "float32"))
def test_decode_step_matches_reference(compute_dtype):
    """Step by step over a 16-token sequence: the logits within 5e-2 of the
    reference's, and the caches the reference's after the last step."""
    jcfg, cfg, jp, p = _pair(compute_dtype=compute_dtype)
    toks = _tokens(cfg.vocab_size, (B, S))
    jcache, cache = jinit_cache(jcfg, B, S), init_cache(cfg, B, S,
                                                        device=CPU)
    errs = []
    for t in range(S):
        jlg, jcache = jdecode_step(jp, jnp.asarray(toks[:, t]),
                                   jnp.int32(t), jcache, jcfg)
        lg, cache = decode_step(p, torch.from_numpy(toks[:, t]), t, cache,
                                cfg)
        assert lg.shape == (B, cfg.vocab_size)
        errs.append(float(np.abs(lg.float().numpy() - np.asarray(
            jlg.astype(jnp.float32))).max()))
    assert max(errs) < DECODE_ATOL, errs
    for k in ("k", "v"):
        want = np.asarray(jcache[k].astype(jnp.float32))
        assert np.abs(cache[k].float().numpy() - want).max() < DECODE_ATOL


def test_decode_matches_own_forward():
    """Decode logits == the port's teacher-forced forward logits; the cache
    is written in place, and ``shard_hints`` changes nothing."""
    _, cfg, _, p = _pair()
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (B, S), seed=5))
    full = forward(p, {"tokens": toks}, cfg)[0].float()
    runs = []
    for variant in (cfg, cfg.replace(shard_hints=True)):
        cache = init_cache(variant, B, S, device=CPU)
        k = cache["k"]
        logs = []
        for t in range(S):
            lg, cache = decode_step(p, toks[:, t], t, cache, variant)
            logs.append(lg.float())
        assert cache["k"] is k and bool(k[:, :, S - 1].abs().sum() > 0)
        runs.append(torch.stack(logs, dim=1))
    assert float((runs[0] - full).abs().max()) < DECODE_ATOL
    assert torch.equal(runs[0], runs[1])


def test_prefill_and_serve_steps():
    """The prefill hands over the last position's logits and the (L,B,S,K,dh)
    cache; a serve step returns the greedy token and the next position."""
    _, cfg, _, p = _pair(compute_dtype="float32")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (B, S), seed=6))
    logits, _, want_cache = forward(p, {"tokens": toks}, cfg,
                                    return_cache=True)
    last, cache = make_prefill_step(cfg)(p, {"tokens": toks})
    assert torch.equal(last, logits[:, -1])
    for k in ("k", "v"):
        assert torch.equal(cache[k], want_cache[k])
    full = init_cache(cfg, B, S + 1, device=CPU)
    for k in ("k", "v"):
        full[k][:, :, :S] = cache[k]
    nxt = torch.argmax(last, dim=-1)
    lg, _ = decode_step(p, nxt, S, {k: v.clone() for k, v in full.items()},
                        cfg)
    full2, token, pos = make_serve_step(cfg)(p, full, nxt, S)
    assert pos == S + 1 and torch.equal(token, torch.argmax(lg, dim=-1))
    assert full2 is full


def _report(r):
    return (r.tokens_emitted, r.queries, r.scrub_corrected, r.scrub_detected,
            r.injected, r.sidecar_overhead)


@pytest.mark.parametrize("policy", (None, "detect_recover",
                                    "typical_server"))
def test_serve_batch_equals_reference(policy):
    """``examples/serve_kv.py``'s run (4 prompts of 16 tokens, 12 new
    tokens, error rate 0.5, seed 9, scrub every 4 tokens): the same tokens
    and counters. At error rate 0 the policy's tokens are the unprotected
    run's."""
    jcfg, cfg, jp, p = _pair(compute_dtype="float32")
    prompts = _tokens(cfg.vocab_size, (4, 16), seed=1)
    jpol = pol = None
    if policy is not None:
        jpol = dataclasses.replace(JDESIGN_POINTS[policy](), scrub_interval=4)
        pol = dataclasses.replace(DESIGN_POINTS[policy](), scrub_interval=4)
    want, jrep = jserve_batch(jcfg, jp, jnp.asarray(prompts, jnp.int32), 12,
                              policy=jpol, error_rate_per_token=0.5, seed=9)
    got, rep = serve_batch(cfg, p, torch.from_numpy(prompts), 12,
                           policy=pol, error_rate_per_token=0.5, seed=9)
    assert got.shape == (4, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _report(rep) == _report(jrep)
    assert rep.injected > 0
    if policy is not None:      # SEC-DED corrects, parity only detects
        assert (rep.scrub_corrected > 0) == (policy == "typical_server")
        assert (rep.scrub_detected > 0) == (policy == "detect_recover")
    clean, _ = serve_batch(cfg, p, torch.from_numpy(prompts), 12,
                           policy=pol, seed=9)
    plain, _ = serve_batch(cfg, p, torch.from_numpy(prompts), 12, seed=9)
    assert torch.equal(clean, plain)


def test_serve_cli_runs(capsys):
    assert serve.main(["--device", CPU, "--policy", "detect_recover",
                       "--error-rate", "0.5", "--batch", "2",
                       "--new-tokens", "8"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and lines[0].startswith("generated: [[")
    assert lines[1].startswith("tokens=16 corrected=")
    assert serve.main(["--device", CPU, "--batch", "2",
                       "--new-tokens", "8"]) == 0
    assert capsys.readouterr().out.splitlines()[1] == \
        "tokens=16 corrected=0 detected=0 injected=0"

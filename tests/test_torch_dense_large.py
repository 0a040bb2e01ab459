"""The 72-405 B dense configs of the port against the JAX reference on the
CPU: qwen2-72b (QKV bias, rope 1e6), nemotron-4-340b (squared-ReLU MLP,
two matrices) and llama3-405b (126 layers, a 128k vocabulary).

At their full configs the port's parameter trees are made on the ``meta``
device and held leaf for leaf (sorted path, shape, dtype) to
``jax.eval_shape`` of the reference's ``init_params``, with the parameter
counts; nothing is allocated. Values are held at the tiny configs in
float32 compute with the reference's seed-0 parameters carried across
through numpy: logits and decode logits within 1e-4 x max|value|, the
loss within 1e-5 relative and each gradient leaf within 1e-4 x its
max|g| (``tests/test_torch_model.py``'s and ``test_torch_frontends.py``'s
tolerances); ``serve_batch`` tokens and counters exactly (tiny qwen2-72b,
the one config with a QKV bias; the reference runs its parity kernels in
Pallas interpret mode); HRM regions of every leaf exactly.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as JASSIGNED_ARCHS
from repro.configs import get_config as jget_config
from repro.configs import get_tiny as jget_tiny
from repro.configs import list_archs as jlist_archs
from repro.core.policy import DESIGN_POINTS as JDESIGN_POINTS
from repro.core.policy import classify_path as jclassify_path
from repro.launch import serve as jserve
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models.transformer import init_cache as jinit_cache
from repro.models.transformer import loss_fn as jloss_fn
from repro.runtime.serve_loop import serve_batch as jserve_batch
from repro_torch.configs import (ASSIGNED_ARCHS, get_config, get_tiny,
                                 list_archs)
from repro_torch.convert import state_from_numpy
from repro_torch.core import DESIGN_POINTS, tree
from repro_torch.core.policy import classify_path
from repro_torch.launch import serve, train
from repro_torch.models import decode_step, forward, init_cache, init_params
from repro_torch.runtime.serve_loop import serve_batch
from repro_torch.runtime.steps import _value_and_grad

CPU = "cpu"
ARCHS = ("qwen2-72b", "nemotron-4-340b", "llama3-405b")
F32_REL = 1e-4
LOSS_RTOL, GRAD_REL = 1e-5, 1e-4
B, S = 2, 16
# full-size parameter counts (bf16: two bytes each)
FULL_PARAMS = {"qwen2-72b": 72_706_203_648,
               "nemotron-4-340b": 341_025_638_400,
               "llama3-405b": 405_853_388_800}


def _pair(arch: str):
    """(reference cfg, port cfg, reference params, port params), float32
    compute, the reference's seed-0 parameters carried across."""
    jcfg = jget_tiny(arch).replace(compute_dtype="float32")
    cfg = get_tiny(arch).replace(compute_dtype="float32")
    jp = jax.jit(jinit_params, static_argnums=(1,))(jax.random.PRNGKey(0),
                                                   jcfg)
    return jcfg, cfg, jp, state_from_numpy(jax.tree.map(np.asarray, jp),
                                           device=CPU)


def _tokens(vocab: int, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def _close(got: torch.Tensor, want, rel: float) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# ------------------------------------------------------ configs and trees
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ("config", "tiny"))
def test_config_equals_reference(arch, size):
    got = (get_config if size == "config" else get_tiny)(arch)
    want = (jget_config if size == "config" else jget_tiny)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.head_dim == want.head_dim


def test_registry_equals_reference():
    assert ASSIGNED_ARCHS == JASSIGNED_ARCHS
    assert list_archs() == jlist_archs()
    cfg = {a: get_config(a) for a in ARCHS}
    assert cfg["qwen2-72b"].qkv_bias and cfg["qwen2-72b"].rope_theta == 1e6
    assert cfg["nemotron-4-340b"].act == "relu2"
    assert (cfg["llama3-405b"].n_layers,
            cfg["llama3-405b"].vocab_size) == (126, 128256)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_meta_tree_equals_reference_eval_shape(arch):
    """Full size, no allocation: the same sorted paths, shapes and dtypes,
    and the same parameter count; the regions of every leaf equal the
    reference's (``bq``/``bk``/``bv`` in params/attn)."""
    jp = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0),
                                             jget_config(arch)))
    want = [(path, leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jp)[0]]
    got = tree.flatten_with_path(init_params(get_config(arch),
                                             device="meta"))[0]
    assert [tuple(k.key for k in p) for p, _ in want] == [p for p, _ in got]
    for (jpath, w), (path, t) in zip(want, got):
        assert t.device.type == "meta"
        assert tuple(t.shape) == w.shape and \
            str(t.dtype)[6:] == str(w.dtype), path
        assert classify_path(path) == jclassify_path(jpath), path
    n = sum(t.numel() for _, t in got)
    assert n == sum(int(np.prod(w.shape)) for _, w in want) == \
        FULL_PARAMS[arch]
    regions = {"/".join(p): classify_path(p) for p, _ in got}
    biases = {k for k in regions if k.split("/")[-1] in ("bq", "bk", "bv")}
    assert (biases == {"blocks/attn/bq", "blocks/attn/bk",
                       "blocks/attn/bv"}) == (arch == "qwen2-72b")
    assert all(regions[k] == "params/attn" for k in biases)
    assert ("blocks/mlp/wg" in regions) == (arch != "nemotron-4-340b")


# ------------------------------------------------------ model entry points
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_decode_loss_and_grads_match_reference(arch):
    """``forward``'s logits and cache, ``decode_step`` over a 16-token
    sequence, and the loss with its gradients, at the tiny config."""
    jcfg, cfg, jp, p = _pair(arch)
    toks = _tokens(cfg.vocab_size, (B, S + 1), seed=1)
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
    b = {"tokens": torch.from_numpy(toks[:, :-1]),
         "labels": torch.from_numpy(toks[:, 1:])}
    want, _, jcache = jax.jit(
        lambda q, x: jforward(q, x, jcfg, return_cache=True))(jp, jb)
    got, aux, cache = forward(p, b, cfg, return_cache=True)
    _close(got, want, F32_REL)
    assert float(aux) == 0.0
    for k in ("k", "v"):
        _close(cache[k], jcache[k], F32_REL)
    jstep = jax.jit(jdecode_step, static_argnums=(4,))
    jc, c = jinit_cache(jcfg, B, S), init_cache(cfg, B, S, device=CPU)
    for t in range(S):
        jlg, jc = jstep(jp, jnp.asarray(toks[:, t], jnp.int32),
                        jnp.int32(t), jc, jcfg)
        lg, c = decode_step(p, torch.from_numpy(toks[:, t]), t, c, cfg)
        _close(lg, jlg, F32_REL)
    _close(torch.stack([c["k"], c["v"]]), jnp.stack([jc["k"], jc["v"]]),
           F32_REL)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda q: jloss_fn(q, jb, jcfg), has_aux=True))(jp)
    loss, grads = _value_and_grad(p, b, cfg, "none")
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    want = {tuple(k.key for k in path): g for path, g in
            jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = dict(tree.flatten_with_path(grads)[0])
    assert list(want) == list(got)
    for k, w in want.items():
        w = np.asarray(w)
        err = float(np.abs(got[k].numpy() - w).max())
        assert err <= GRAD_REL * np.abs(w).max() + 1e-12, (k, err)


def test_serve_batch_equals_reference_with_qkv_bias():
    """Tiny qwen2-72b under detect_recover, 4 prompts of 16 tokens, 12 new
    tokens, error rate 0.5 and a scrub every 4 tokens: the same tokens and
    counters as the reference's."""
    jcfg, cfg, jp, p = _pair("qwen2-72b")
    assert cfg.qkv_bias
    prompts = _tokens(cfg.vocab_size, (4, 16), seed=1)
    jpol = dataclasses.replace(JDESIGN_POINTS["detect_recover"](),
                               scrub_interval=4)
    pol = dataclasses.replace(DESIGN_POINTS["detect_recover"](),
                              scrub_interval=4)
    want, jrep = jserve_batch(jcfg, jp, jnp.asarray(prompts, jnp.int32), 12,
                              policy=jpol, error_rate_per_token=0.5, seed=9)
    got, rep = serve_batch(cfg, p, torch.from_numpy(prompts), 12,
                           policy=pol, error_rate_per_token=0.5, seed=9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fields = ("tokens_emitted", "queries", "scrub_corrected",
              "scrub_detected", "injected", "sidecar_overhead")
    assert [getattr(rep, f) for f in fields] == \
        [getattr(jrep, f) for f in fields]
    assert rep.injected > 0 and rep.scrub_detected > 0


# ------------------------------------------------------------------ CLIs
def test_serve_cli_prints_the_reference_counters(capsys, monkeypatch):
    """``launch.serve --arch qwen2-72b`` (tiny) under detect_recover with
    strikes: the counters line equals the reference's (the generated
    tokens differ: the two packages draw other parameters)."""
    args = ["--arch", "qwen2-72b", "--batch", "2", "--new-tokens", "8",
            "--policy", "detect_recover", "--error-rate", "0.5"]
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jserve.main()
    want = capsys.readouterr().out.splitlines()
    assert serve.main(args + ["--device", CPU]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got[0].startswith("generated: [[") and got[1] == want[1]
    assert "injected=0" not in got[1]


def test_train_cli_runs_nemotron(tmp_path, capsys):
    """``launch.train --arch nemotron-4-340b --tiny``: 4 steps under
    detect_recover with strikes and a restart drill, finite losses."""
    assert train.main(["--arch", "nemotron-4-340b", "--tiny", "--steps", "4",
                       "--batch", "2", "--seq", "16", "--policy",
                       "detect_recover", "--error-rate", "0.5",
                       "--ckpt-dir", str(tmp_path), "--device", CPU]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("steps=4 loss: ")
    losses = [float(x) for x in out[0].split("loss: ")[1].split(" -> ")]
    assert all(np.isfinite(losses))
    assert "injected=0 " not in out[1]

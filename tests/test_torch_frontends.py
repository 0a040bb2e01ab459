"""The port's audio and vision frontends against the JAX reference on the
CPU, at tiny hubert-xlarge (family ``audio``: projected frame embeddings,
bidirectional, no RoPE, no decode) and tiny llava-next-mistral-7b (family
``vlm``: projected patch embeddings prepended to the text): the configs,
the parameter trees and their HRM regions, the batches, ``forward``,
``loss_fn`` and its gradients, the patch-prefixed prefill and
``decode_step``, the paged decode step, a Fig. 2 campaign and the train
CLI; and the places where the reference fails (``serve_batch``,
``prefill_write``, ``init_cache`` of the audio family, the serve CLI),
where the port must fail with the same exception. The reference's seed-0
parameters are carried across through numpy; inputs come from a numpy
seed.

Tolerances, all in float32 compute: logits, caches and decode logits
within 1e-4 x max|value| of the reference's (the two frameworks sum the
products in other orders); the loss within 1e-5 relative and each
gradient leaf within 1e-4 x its max|g|. Batches, greedy tokens, campaign
outcomes and the train loop's counters are compared exactly; paged decode
equals the port's contiguous ``decode_step`` bit for bit.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.characterize as jchar
from repro.configs import get_config as jget_config
from repro.configs import get_tiny as jget_tiny
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core.policy import classify_path as jclassify_path
from repro.data import synthetic as jsyn
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models.transformer import init_cache as jinit_cache
from repro.models.transformer import loss_fn as jloss_fn
from repro.runtime.serve_loop import serve_batch as jserve_batch
from repro.runtime.steps import make_prefill_step as jmake_prefill_step
from repro.serve.engine import _make_paged_decode as jmake_paged_decode
from repro.serve.engine import _make_prefill_write as jmake_prefill_write
from repro_torch.configs import get_config, get_tiny
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import state_from_numpy
from repro_torch.core import characterize, tree
from repro_torch.core.policy import classify_path
from repro_torch.data import synthetic
from repro_torch.launch import serve, train
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params)
from repro_torch.models.transformer import paged_decode_logits, prefill_write
from repro_torch.runtime.serve_loop import _with_headroom, serve_batch
from repro_torch.runtime.steps import _value_and_grad, make_prefill_step
from repro_torch.serve import PagedKVCache

CPU = "cpu"
AUDIO, VLM = "hubert-xlarge", "llava-next-mistral-7b"
ARCHS = (AUDIO, VLM)
F32_REL = 1e-4
LOSS_RTOL, GRAD_REL = 1e-5, 1e-4
SEQ = 32        # frames, or tiny llava's 8 patches and 24 text tokens


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _pair(arch: str):
    """(reference cfg, port cfg, reference params, port params), float32
    compute, the reference's seed-0 parameters carried across."""
    jcfg = jget_tiny(arch).replace(compute_dtype="float32")
    cfg = get_tiny(arch).replace(compute_dtype="float32")
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, state_from_numpy(_np(jp), device=CPU)


def _batches(jcfg, cfg, batch: int = 2, seq: int = SEQ, seed: int = 0):
    """The reference's and the port's ``make_batch`` from one seed."""
    return (jsyn.make_batch(jcfg, JShapeSpec("t", seq, batch, "train"),
                            seed=seed),
            synthetic.make_batch(cfg, ShapeSpec("t", seq, batch, "train"),
                                 seed=seed, device=CPU))


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


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_regions_equal_reference(arch):
    """Paths in sorted order, shapes, dtypes and HRM regions:
    ``frame_proj`` in place of ``embed`` for audio, ``patch_proj`` beside
    it for vlm, both in params/embed."""
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
    proj = "frame_proj" if arch == AUDIO else "patch_proj"
    regions = {"/".join(p): classify_path(p) for p, _ in got}
    assert regions[proj] == regions["head"] == "params/embed"
    assert ("embed" in regions) == (arch == VLM)


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_equal_reference(arch):
    jcfg, cfg = jget_tiny(arch), get_tiny(arch)
    want, got = _batches(jcfg, cfg, batch=3, seed=7)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == (torch.float32 if k in ("frames", "patches")
                                else torch.int64)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    stream = synthetic.batch_stream(cfg, 2, 16, seed=5, device=CPU)
    jstream = jsyn.batch_stream(jcfg, 2, 16, seed=5)
    for _ in range(2):
        a, b = next(stream), next(jstream)
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


# ------------------------------------------------------ model entry points
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_cache_match_reference(arch):
    jcfg, cfg, jp, p = _pair(arch)
    jb, b = _batches(jcfg, cfg)
    want, jaux, jcache = jforward(jp, jb, jcfg, return_cache=True)
    got, aux, cache = forward(p, b, cfg, return_cache=True)
    assert tuple(got.shape) == (2, SEQ, cfg.vocab_size)
    _close(got, want, F32_REL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))
    assert float(aux) == float(jaux) == 0.0
    for k in ("k", "v"):
        _close(cache[k], jcache[k], F32_REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """llava's loss covers the text positions only: its labels are as long
    as the text, not as the patch-prefixed sequence."""
    jcfg, cfg, jp, p = _pair(arch)
    jb, b = _batches(jcfg, cfg, seed=6)
    if arch == VLM:
        assert b["labels"].shape[1] == SEQ - cfg.n_patches
    (jl, _), jg = jax.value_and_grad(
        lambda q: jloss_fn(q, jb, jcfg), has_aux=True)(jp)
    loss, grads = _value_and_grad(p, b, cfg, "none")
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    want = {"/".join(k.key for k in path): g for path, g in
            jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = {"/".join(path): g for path, g in tree.flatten_with_path(grads)[0]}
    assert list(want) == list(got)
    for k in want:
        w = np.asarray(want[k])
        err = float(np.abs(got[k].numpy() - w).max())
        assert err <= GRAD_REL * np.abs(w).max() + 1e-12, (k, err)


def test_encoder_bidirectional():
    """Mirror of ``tests/test_models.py::test_encoder_bidirectional``:
    perturbing the last frame changes the first frame's logits."""
    cfg = get_tiny(AUDIO)
    p = init_params(cfg, seed=0, device=CPU)
    b = synthetic.make_batch(cfg, ShapeSpec("s", SEQ, 2, "train"),
                             device=CPU)
    l1 = forward(p, b, cfg)[0]
    frames = b["frames"].clone()
    frames[:, -1] += 10.0
    l2 = forward(p, {**b, "frames": frames}, cfg)[0]
    assert float((l1[:, 0] - l2[:, 0]).abs().max()) > 1e-6


def test_vlm_patch_prefix_changes_text_logits():
    """Mirror of ``tests/test_models.py::
    test_vlm_patch_prefix_changes_text_logits``."""
    cfg = get_tiny(VLM)
    p = init_params(cfg, seed=0, device=CPU)
    b = synthetic.make_batch(cfg, ShapeSpec("s", SEQ, 2, "train"),
                             device=CPU)
    l1 = forward(p, b, cfg)[0]
    l2 = forward(p, {**b, "patches": b["patches"] + 1.0}, cfg)[0]
    assert float((l1 - l2).abs().max()) > 1e-6


def _prefill(jcfg, cfg, jp, p, new: int):
    """Both packages' ``make_prefill_step`` on a patch-prefixed batch of 2:
    (reference batch, port batch, S0, reference and port first tokens,
    reference and port decode caches sized S0 + new)."""
    jb, b = _batches(jcfg, cfg, seed=3)
    S0 = cfg.n_patches + b["tokens"].shape[1]
    jlast, jc = jmake_prefill_step(jcfg)(jp, {"tokens": jb["tokens"],
                                              "patches": jb["patches"]})
    last, c = make_prefill_step(cfg)(p, {"tokens": b["tokens"],
                                         "patches": b["patches"]})
    _close(last, jlast, F32_REL)
    jfull = jinit_cache(jcfg, 2, S0 + new)
    jfull = {k: jfull[k].at[:, :, :S0].set(jc[k]) for k in jfull}
    full = _with_headroom(c, init_cache(cfg, 2, S0 + new, device=CPU))
    return jb, b, S0, jnp.argmax(jlast, -1), torch.argmax(last, -1), \
        jfull, full


def test_vlm_decode_after_patch_prefill_matches_reference():
    """The prefill on tokens and patches, then 8 ``decode_step`` tokens
    (the same tokens fed to both): logits and the final cache within
    1e-4 x max|value| of the reference's, and the decode logits within as
    much of the port's ``forward`` over the extended sequence."""
    jcfg, cfg, jp, p = _pair(VLM)
    new = 8
    jb, b, S0, jtok, tok, jcache, cache = _prefill(jcfg, cfg, jp, p, new)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    jstep = jax.jit(jdecode_step, static_argnums=(4,))
    gen, logs = [], []
    for t in range(new):
        gen.append(tok)
        jlg, jcache = jstep(jp, jnp.asarray(tok.numpy(), jnp.int32),
                            jnp.int32(S0 + t), jcache, jcfg)
        lg, cache = decode_step(p, tok, S0 + t, cache, cfg)
        _close(lg, jlg, F32_REL)
        logs.append(lg)
        tok = torch.argmax(lg, -1)
    for k in cache:
        _close(cache[k], jcache[k], F32_REL)
    seq = torch.cat([b["tokens"], torch.stack(gen, 1)], 1)
    full = forward(p, {"tokens": seq, "patches": b["patches"]}, cfg)[0]
    want = full[:, S0:]
    dec = torch.stack(logs, 1)
    assert float((dec - want).abs().max()) <= \
        F32_REL * float(want.abs().max())


def test_vlm_paged_decode_matches_reference():
    """Two slots prefilled with patches (the pages written from the
    prefill's cache: neither package's ``prefill_write`` takes patches),
    then 6 paged decode steps: the port's paged logits equal its
    contiguous ``decode_step``'s bit for bit, its greedy tokens equal the
    reference's paged step's, and the pages the reference's within
    1e-4 x max|value| (page 0, the null page, skipped)."""
    jcfg, cfg, jp, p = _pair(VLM)
    new, ps = 6, 8
    jb, b, S0, jtok, tok, jfull, full = _prefill(jcfg, cfg, jp, p, new)
    cache = PagedKVCache(cfg, n_pages=11, page_size=ps, slots=2,
                         max_pages_per_slot=5, device=CPU)
    n_pp = S0 // ps
    jpk, jpv = np.zeros(cache.pool_k.shape, np.float32), \
        np.zeros(cache.pool_v.shape, np.float32)
    for i in range(2):
        pages = torch.from_numpy(cache.alloc(i, S0 + new).astype(np.int64))
        for pool, jpool, k in ((cache.pool_k, jpk, "k"),
                               (cache.pool_v, jpv, "v")):
            L = pool.shape[0]
            pool[:, pages[:n_pp]] = full[k][:, i, :S0].reshape(
                L, n_pp, ps, *pool.shape[3:])
            jpool[:, pages[:n_pp].numpy()] = np.asarray(
                jfull[k][:, i, :S0]).reshape(L, n_pp, ps, *pool.shape[3:])
    cache.check_invariants()
    table = cache.device_table()
    jstep = jax.jit(jmake_paged_decode(jcfg, ps))
    jpk, jpv = jnp.asarray(jpk), jnp.asarray(jpv)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for t in range(new):
        pos = torch.full((2,), S0 + t)
        want, full = decode_step(p, tok, S0 + t, full, cfg)
        got = paged_decode_logits(p, cache.pools, table, tok, pos, cfg,
                                  ps)
        assert torch.equal(got, want), t
        jpk, jpv, jnxt, ok = jstep(jp, jpk, jpv, jnp.asarray(cache.table),
                                   jnp.asarray(tok.numpy(), jnp.int32),
                                   jnp.asarray(pos.numpy(), jnp.int32))
        tok = torch.argmax(got, -1)
        assert bool(ok)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jnxt))
    _close(cache.pool_k[:, 1:], jpk[:, 1:], F32_REL)
    _close(cache.pool_v[:, 1:], jpv[:, 1:], F32_REL)


# ------------------------------------------------------------- campaign
@pytest.mark.parametrize("arch", ARCHS)
def test_campaign_outcomes_and_regions_equal_reference(arch):
    """A Fig. 2 campaign (8 soft and 8 hard trials, the query
    ``lm_eval_fn``'s greedy tokens over a batch of 2): the same strikes,
    the same outcome trial by trial and the same regions; ``frame_proj``
    or ``patch_proj`` counts as params/embed."""
    jcfg, cfg, jp, p = _pair(arch)
    jb, b = _batches(jcfg, cfg, seed=8)
    jev = jax.jit(lambda q: jchar.lm_eval_fn(jcfg, jb, jforward)(q)[0])
    ev = characterize.lm_eval_fn(cfg, b, forward)
    ref, port, jregions, regions = [], [], set(), set()
    run_trial = jchar._run_trial

    def record(domain, s, plan, *a, **k):
        ref.append((s.path, run_trial(domain, s, plan, *a, **k)))
        return ref[-1][1]

    for kind in ("soft", "hard"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jchar, "_run_trial", record)
            jres = jchar.run_campaign(lambda q: (jev(q), q), jp, n_trials=8,
                                      seed=3, kinds=(kind,))
        res = characterize.run_campaign(ev, p, n_trials=8, seed=3,
                                        kinds=(kind,))
        port += res.trials
        jregions |= set(jres.regions())
        regions |= set(res.regions())
    assert len(port) == 16
    assert [(path, o.value) for path, o in ref] == \
        [(path, o.value) for path, _, o in port]
    assert regions == jregions
    assert classify_path(("frame_proj",)) == \
        classify_path(("patch_proj",)) == "params/embed"


# ------------------------------------------------------------------ CLIs
@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_as_the_reference(arch, tmp_path, capsys,
                                           monkeypatch):
    """``launch.train --tiny`` on each frontend, each package with a
    checkpoint directory of its own: 4 steps under detect_recover with
    strikes, the same counters (the losses differ: the two packages draw
    other parameters)."""
    args = ["--arch", arch, "--tiny", "--steps", "4", "--batch", "2",
            "--seq", "24", "--policy", "detect_recover", "--error-rate",
            "0.5", "--scrub-interval", "2"]
    monkeypatch.setattr(sys, "argv", ["train"] + args + [
        "--ckpt-dir", str(tmp_path / "ref")])
    jtrain.main()
    want = capsys.readouterr().out.splitlines()
    assert train.main(args + ["--ckpt-dir", str(tmp_path / "port"),
                              "--device", CPU]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got[0].startswith("steps=4 loss: ") and \
        want[0].startswith("steps=4 loss: ")
    counters = (lambda line: line.split(" stragglers=")[0])
    assert counters(got[1]) == counters(want[1])
    assert "injected=0 " not in got[1]


# ------------------------------------------------ where the reference fails
def _raises_alike(ref_fn, port_fn):
    """``port_fn`` raises what ``ref_fn`` raises, type and arguments."""
    with pytest.raises(Exception) as want:
        ref_fn()
    with pytest.raises(want.type) as got:
        port_fn()
    assert got.value.args == want.value.args
    return got.value


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_fails_as_the_reference(arch):
    """``serve_batch`` prefills tokens only: KeyError on the frames or the
    patches, in both packages."""
    jcfg, cfg, jp, p = _pair(arch)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    err = _raises_alike(
        lambda: jserve_batch(jcfg, jp, jnp.asarray(prompts, jnp.int32), 4),
        lambda: serve_batch(cfg, p, torch.from_numpy(prompts), 4))
    assert isinstance(err, KeyError)


def test_prefill_write_and_audio_cache_fail_as_the_reference():
    """The paged prefill of a VLM prompt (no patches: KeyError) and the
    audio family's decode cache (ValueError, the reference's message)."""
    jcfg, cfg, jp, p = _pair(VLM)
    cache = PagedKVCache(cfg, n_pages=4, page_size=8, slots=1,
                         max_pages_per_slot=2, device=CPU)
    toks = np.ones((1, 8), np.int64)
    pages = np.array([1], np.int64)
    err = _raises_alike(
        lambda: jmake_prefill_write(jcfg, 8)(
            jp, jnp.asarray(cache.pool_k.numpy()),
            jnp.asarray(cache.pool_v.numpy()), jnp.asarray(toks, jnp.int32),
            8, jnp.asarray(pages, jnp.int32)),
        lambda: prefill_write(p, cache.pools, torch.from_numpy(toks), 8,
                              torch.from_numpy(pages), cfg, 8))
    assert isinstance(err, KeyError)
    err = _raises_alike(lambda: jinit_cache(jget_tiny(AUDIO), 1, 8),
                        lambda: init_cache(get_tiny(AUDIO), 1, 8,
                                           device=CPU))
    assert isinstance(err, ValueError)
    with pytest.raises(ValueError, match="attention-cache"):
        PagedKVCache(get_tiny(AUDIO), n_pages=4, page_size=8, slots=1,
                     max_pages_per_slot=1, device=CPU)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_fails_as_the_reference(arch, monkeypatch):
    args = ["--arch", arch, "--tiny", "--batch", "2", "--new-tokens", "4"]
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    err = _raises_alike(jserve.main,
                        lambda: serve.main(args + ["--device", CPU]))
    assert isinstance(err, KeyError)

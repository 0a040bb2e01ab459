"""The port's training path against the JAX reference on the CPU: the
cross-entropy, ``loss_fn`` and its gradients, remat, AdamW, the int8
gradient compression, the train step, the fault-tolerant train loop and
the ``launch.train`` CLI, on tiny lm-100m with the reference's state
carried across through numpy.

Tolerances, each against the reference on the same inputs:

* cross-entropy in float32: rtol 1e-6 (one logsumexp and one gather; the
  two libraries reduce in different orders);
* ``loss_fn`` at float32 compute: loss rtol 1e-5, each gradient leaf
  within 1e-4 of its largest magnitude; at bfloat16 compute: loss rtol
  1e-3, each gradient leaf within 5e-2 of its largest magnitude (the
  products round to bf16, 2**-8 relative, in an order that differs);
* remat: ``"full"`` and ``"dots"`` recompute the same operations, so loss
  and gradients equal ``"none"``'s within 1e-6;
* AdamW on identical inputs: float32 leaves within 1e-6 of each leaf's
  largest magnitude (the clip scale carries ``grad_norm``'s last-ulp
  difference into every element, and ``p - lr * (...)`` cancels where p
  is near 0, so an element-wise ratio is ill-posed there), bf16
  parameters within one bf16 ulp, ``count`` equal, ``grad_norm`` within
  rtol 1e-6 (a float32 sum of squares reduced in another order: one or
  two ulps);
* ``quantize_leaf``: ``q``, ``scale`` and the error feedback bit for bit;
* one train step at float32 compute: loss rtol 1e-5, ``grad_norm`` rtol
  1e-6, moments within 1e-4 of each leaf's largest magnitude, the error
  feedback within 1e-3 of its largest (it is the gradient less its int8
  rounding, about 1/254 of the gradient's largest, so the gradients'
  float noise is some 250 times larger against it), and parameters
  within lr / 10 (the first Adam step moves an element by about lr times
  the sign of its gradient, which float noise can flip where the
  gradient is near 0);
* four train steps with bf16 parameters: losses rtol 1e-3, ``grad_norm``
  rtol 5e-3 (the parameters round to bf16 after each update);
* the train loop: strikes, scrub counts, recoveries, restarts, domain
  stats and the non-straggler events equal (they follow the numpy
  stream and the struck bits, not the values); losses within rtol 1e-3
  (bf16 compute over 14 steps, with the same checkpoint reloads);
* a struck top exponent bit: which losses are finite, step by step,
  equal (no tolerance: the strike makes a weight some 2**128 times
  larger, which neither package's step survives);
* ``examples/train_hrm.py``'s strike stream at lm-100m's full config:
  every strike's step, leaf, hardness, words and bits equal.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_tiny as jget_tiny
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import HRMPolicy as JHRMPolicy
from repro.core import MemoryDomain as JMemoryDomain
from repro.core import Response as JResponse
from repro.kernels import ops as jops
from repro.core.policy import DESIGN_POINTS as JDESIGN_POINTS
from repro.data.synthetic import batch_stream as jbatch_stream
from repro.launch import train as jtrain_cli
from repro.models.common import cross_entropy as jcross_entropy
from repro.models.transformer import init_params as jinit_params
from repro.models.transformer import loss_fn as jloss_fn
from repro.optim.adamw import adamw_update as jadamw_update
from repro.optim.compress import quantize_leaf as jquantize_leaf
from repro.runtime.steps import init_train_state as jinit_train_state
from repro.runtime.steps import make_train_step as jmake_train_step
from repro.runtime.train_loop import LoopConfig as JLoopConfig
from repro.runtime.train_loop import run_training as jrun_training
from repro_torch.configs import get_tiny
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import state_from_numpy
from repro_torch.core import (DESIGN_POINTS, HRMPolicy, MemoryDomain,
                              Response, tree)
from repro_torch.data.synthetic import batch_stream
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models.common import cross_entropy, cross_entropy_sharded
from repro_torch.optim.adamw import adamw_update
from repro_torch.optim.compress import (compress_grads, dequantize_leaf,
                                        ef_init, quantize_leaf)
from repro_torch.runtime.steps import _value_and_grad, make_train_step
from repro_torch.runtime.train_loop import LoopConfig, run_training

CPU = "cpu"
B, S = 4, 32


def _np(x) -> np.ndarray:
    """A reference array or port tensor as float64 (bf16 by value)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64)
                      if jnp.asarray(x).dtype == jnp.bfloat16
                      else x).astype(np.float64)


def _jflat(t):
    return {"/".join(str(getattr(e, "key", e)) for e in path): x
            for path, x in jax.tree_util.tree_flatten_with_path(t)[0]}


def _tflat(t):
    return {"/".join(path): x for path, x in tree.flatten_with_path(t)[0]}


def _pair(compute_dtype="float32", grad_compress=False):
    """(reference cfg, port cfg, reference train state, port train state)."""
    jcfg = jget_tiny("lm-100m").replace(compute_dtype=compute_dtype)
    cfg = get_tiny("lm-100m").replace(compute_dtype=compute_dtype)
    js = jinit_train_state(jax.random.PRNGKey(0), jcfg,
                           JTrainConfig(grad_compress=grad_compress))
    return jcfg, cfg, js, state_from_numpy(jax.tree.map(np.asarray, js),
                                           device=CPU)


def _batches(vocab: int, seed: int = 1):
    t = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    return ({"tokens": jnp.asarray(t[:, :-1], jnp.int32),
             "labels": jnp.asarray(t[:, 1:], jnp.int32)},
            {"tokens": torch.from_numpy(t[:, :-1]),
             "labels": torch.from_numpy(t[:, 1:])})


# ------------------------------------------------------------ loss
@pytest.mark.parametrize("masked", (False, True))
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7))
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked \
        else None
    want = float(jcross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                None if mask is None
                                else jnp.asarray(mask)))
    tm = None if mask is None else torch.from_numpy(mask)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        tm)
    sharded = cross_entropy_sharded(torch.from_numpy(logits),
                                    torch.from_numpy(labels), tm)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    np.testing.assert_allclose(float(sharded), float(got), rtol=1e-6)


@pytest.mark.parametrize("compute_dtype,loss_rtol,grad_rel", (
    ("float32", 1e-5, 1e-4), ("bfloat16", 1e-3, 5e-2)))
def test_loss_and_grads_match_reference(compute_dtype, loss_rtol, grad_rel):
    jcfg, cfg, js, ts = _pair(compute_dtype)
    jb, tb = _batches(cfg.vocab_size)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jloss_fn(p, jb, jcfg), has_aux=True)(js["params"])
    loss, grads = _value_and_grad(ts["params"], tb, cfg, "none")
    np.testing.assert_allclose(float(loss), float(jl), rtol=loss_rtol)
    want, got = _jflat(jg), _tflat(grads)
    assert list(want) == list(got)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].shape == \
            want[k].shape
        w = _np(want[k])
        err = np.abs(_np(got[k]) - w).max()
        assert err <= grad_rel * np.abs(w).max(), (k, err)


@pytest.mark.parametrize("remat", ("full", "dots"))
def test_remat_equals_no_remat(remat):
    _, cfg, _, ts = _pair("float32")
    _, tb = _batches(cfg.vocab_size)
    l0, g0 = _value_and_grad(ts["params"], tb, cfg, "none")
    l1, g1 = _value_and_grad(ts["params"], tb, cfg, remat)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for (k, a), b in zip(_tflat(g0).items(), tree.leaves(g1)):
        assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max()), k


# ------------------------------------------------------------ optim
def _adam_inputs(count: int):
    """Identical numpy params (f32 and bf16 leaves), grads and moments."""
    rng = np.random.default_rng(3)
    shapes = {"a": (64, 48), "b": {"c": (300,), "d": (5, 7)}}

    def tree_of(fn, s=shapes):
        return {k: tree_of(fn, v) if isinstance(v, dict) else fn(k, v)
                for k, v in s.items()}
    params = tree_of(lambda k, s: rng.standard_normal(s).astype(np.float32))
    grads = tree_of(lambda k, s: (rng.standard_normal(s) * 0.3).astype(
        np.float32))
    m = tree_of(lambda k, s: (rng.standard_normal(s) * 0.01).astype(
        np.float32))
    v = tree_of(lambda k, s: (rng.random(s) * 1e-3).astype(np.float32))
    bf = ("c",)                   # a bf16 parameter leaf and its grad

    def to_bf16(t):
        return {k: to_bf16(x) if isinstance(x, dict) else
                (np.asarray(jnp.asarray(x, jnp.bfloat16)) if k in bf else x)
                for k, x in t.items()}
    return to_bf16(params), to_bf16(grads), m, v, np.int32(count)


@pytest.mark.parametrize("count", (0, 6))
def test_adamw_update_matches_reference(count):
    params, grads, m, v, c = _adam_inputs(count)
    tcfg, jtcfg = TrainConfig(lr=1e-2), JTrainConfig(lr=1e-2)
    jp, jopt, jmet = jadamw_update(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
         "count": jnp.asarray(c)}, jtcfg)
    t = state_from_numpy({"p": params, "g": grads, "m": m, "v": v,
                          "count": np.asarray(c)}, device=CPU)
    tp, topt, tmet = adamw_update(t["p"], t["g"], {
        "m": t["m"], "v": t["v"], "count": t["count"]}, tcfg)
    assert topt["count"].dtype == torch.int32
    assert int(topt["count"]) == int(jopt["count"]) == count + 1
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-6)
    for name, want, got in (("p", jp, tp), ("m", jopt["m"], topt["m"]),
                            ("v", jopt["v"], topt["v"])):
        for (k, w), g in zip(_jflat(want).items(), tree.leaves(got)):
            if w.dtype == jnp.bfloat16:
                assert g.dtype == torch.bfloat16
                wi = np.asarray(w).view(np.int16).astype(np.int32)
                gi = g.view(torch.int16).numpy().astype(np.int32)
                assert np.abs(wi - gi).max() <= 1, (name, k)
            else:
                assert g.dtype == torch.float32
                w = np.asarray(w)
                err = np.abs(g.numpy() - w).max()
                assert err <= 1e-6 * np.abs(w).max(), (name, k, err)


def test_quantize_leaf_bit_equal():
    rng = np.random.default_rng(4)
    g = (rng.standard_normal((129, 33)) * 1e-2).astype(np.float32)
    g[0, :4] = (0.5, -0.5, 1.5, -2.5)           # ties at scale 1 if max
    ef = (rng.standard_normal((129, 33)) * 1e-4).astype(np.float32)
    jq, js, jef = jquantize_leaf(jnp.asarray(g), jnp.asarray(ef))
    q, scale, ef2 = quantize_leaf(torch.from_numpy(g), torch.from_numpy(ef))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.numpy().tobytes() == np.asarray(js).tobytes()
    assert ef2.numpy().tobytes() == np.asarray(jef).tobytes()
    # compress_grads: the round trip applied leaf by leaf
    grads = {"w": torch.from_numpy(g)}
    out, new_ef, saved = compress_grads(grads, ef_init(grads))
    q0, s0, e0 = quantize_leaf(grads["w"], torch.zeros_like(grads["w"]))
    assert torch.equal(out["w"], dequantize_leaf(q0, s0))
    assert torch.equal(new_ef["w"], e0) and saved == 0.75


@pytest.mark.parametrize("microbatches", (1, 2))
def test_train_step_matches_reference(microbatches):
    jcfg, cfg, js, ts = _pair("float32", grad_compress=True)
    jb, tb = _batches(cfg.vocab_size, seed=2)
    tcfg = TrainConfig(microbatches=microbatches, grad_compress=True)
    jtcfg = JTrainConfig(microbatches=microbatches, grad_compress=True)
    jnew, jm = jax.jit(jmake_train_step(jcfg, jtcfg))(js, jb)
    new, m = make_train_step(cfg, tcfg)(ts, tb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    want, got = _jflat(jnew), _tflat(new)
    assert list(want) == list(got)
    assert int(got["opt/count"]) == int(want["opt/count"]) == 1
    for k in want:
        w, g = _np(want[k]), _np(got[k])
        if k.startswith("params/"):
            assert np.abs(g - w).max() <= tcfg.lr / 10, k
        else:
            rel = 1e-3 if k.startswith("ef/") else 1e-4
            assert np.abs(g - w).max() <= rel * np.abs(w).max(), k


def test_train_steps_with_bf16_params_track_reference():
    """Tiny llama3-8b with bf16 parameters and float32 moments, as the
    full-width llama3-8b training runs: four steps from the same state on
    the same batches. Parameters round to bf16 after every update, in an
    order that differs, so the losses stay within rtol 1e-3 and
    ``grad_norm`` within 5e-3, and no more."""
    jcfg = jget_tiny("llama3-8b").replace(param_dtype="bfloat16")
    cfg = get_tiny("llama3-8b").replace(param_dtype="bfloat16")
    js = jinit_train_state(jax.random.PRNGKey(0), jcfg, JTrainConfig())
    ts = state_from_numpy(jax.tree.map(np.asarray, js), device=CPU)
    assert ts["params"]["embed"].dtype == torch.bfloat16
    assert ts["opt"]["m"]["embed"].dtype == torch.float32
    jstep = jax.jit(jmake_train_step(jcfg, JTrainConfig(remat="none")))
    step = make_train_step(cfg, TrainConfig(remat="none"))
    for i in range(4):
        jb, tb = _batches(cfg.vocab_size, seed=10 + i)
        js, jm = jstep(js, jb)
        ts, m = step(ts, tb)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=5e-3)
    assert ts["params"]["embed"].dtype == torch.bfloat16
    assert int(ts["opt"]["count"]) == 4


# ------------------------------------------------------------ loop
def _scenario(name, tmp_path, pkg):
    """``tests/test_substrate.py``'s two train-loop scenarios."""
    points, Loop, resp = (JDESIGN_POINTS, JLoopConfig, JResponse) \
        if pkg == "jax" else (DESIGN_POINTS, LoopConfig, Response)
    if name == "detect_recover":
        policy = points["detect_recover"]()
        object.__setattr__(policy, "scrub_interval", 4)
        return Loop(steps=14, ckpt_interval=5, ckpt_dir=str(tmp_path / pkg),
                    error_rate_per_step=0.5, node_failure_steps=(8,),
                    policy=policy, response=resp.RELOAD_CLEAN_COPY, seed=3)
    policy = points["typical_server"]()
    object.__setattr__(policy, "scrub_interval", 2)
    return Loop(steps=8, ckpt_interval=4, ckpt_dir=str(tmp_path / pkg),
                error_rate_per_step=1.0, policy=policy, seed=4)


def _counters(r):
    return (r.injected, r.scrub_corrected, r.scrub_detected, r.recoveries,
            r.restarts, r.domain_stats,
            [e for e in r.events if "straggler" not in e])


@pytest.mark.parametrize("scenario", ("detect_recover", "typical_server"))
def test_run_training_matches_reference(scenario, tmp_path):
    jcfg, cfg, js, ts = _pair("bfloat16")
    want = jrun_training(jcfg, JTrainConfig(remat="none"),
                         _scenario(scenario, tmp_path, "jax"),
                         jbatch_stream(jcfg, B, S), state=js)
    got = run_training(cfg, TrainConfig(remat="none"),
                       _scenario(scenario, tmp_path, "torch"),
                       batch_stream(cfg, B, S, device=CPU), state=ts,
                       device=CPU)
    assert _counters(got) == _counters(want)
    assert got.injected > 0
    if scenario == "detect_recover":
        assert got.restarts == 1 and got.recoveries > 0
    else:
        assert got.scrub_corrected > 0
    assert len(got.losses) == len(want.losses)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-3)


def test_struck_top_exponent_bit_breaks_both_packages_alike():
    """Bit 30 of a float32 in ``params/head`` (the top exponent bit: a
    weight of about 0.07 becomes about 2.5e37) struck between two steps:
    in both packages the struck step's loss is inf or above 1e30 and every
    later loss is NaN, since the clip scales the inf gradient norm into
    every parameter before any scrub can see it."""
    jcfg, cfg, js, _ = _pair("bfloat16")
    jstep = jax.jit(jmake_train_step(jcfg, JTrainConfig(remat="none")))
    step = make_train_step(cfg, TrainConfig(remat="none"))
    jb, tb = _batches(cfg.vocab_size, seed=20)
    js, _ = jstep(js, jb)
    struck = jax.tree.map(np.array, js)
    head = struck["params"]["head"].reshape(-1).view(np.uint32)
    head[0] ^= np.uint32(1 << 30)
    js = jax.tree.map(jnp.asarray, struck)
    ts = state_from_numpy(struck, device=CPU)
    want, got = [], []
    for i in range(4):
        jb, tb = _batches(cfg.vocab_size, seed=21 + i)
        js, jm = jstep(js, jb)
        ts, m = step(ts, tb)
        want.append(float(jm["loss"]))
        got.append(float(m["loss"]))
    assert np.array_equal(np.isfinite(got), np.isfinite(want)), (got, want)
    for losses in (want, got):
        assert not np.isfinite(losses[0]) or losses[0] > 1e30, losses
        assert np.all(np.isnan(losses[1:])), losses


def _train_hrm_strikes(domain, ops_mod, monkeypatch) -> list:
    """``examples/train_hrm.py``'s strikes (seed 0, 100 steps, 0.2 strikes a
    step, 30 % hard, a checkpoint every 25, a node failure at step 60), in
    ``run_training``'s draw order, through ``domain.inject``; the bit-flip
    kernel is replaced by a recorder, so shape-only leaves do."""
    drawn = []
    monkeypatch.setattr(ops_mod, "inject_bitflips", lambda leaf, w, b: (
        drawn.append((np.asarray(w).tolist(), np.asarray(b).tolist()))
        or leaf))
    rng = np.random.default_rng(0 + 2)
    out, step, fired = [], 0, False
    while step < 100:
        for _ in range(rng.poisson(0.2)):
            hard = rng.random() < 0.3
            domain, (ev,) = domain.inject(rng, 1, hard=hard)
            out.append((step, ev["path"], hard) + drawn.pop())
        if step == 60 and not fired:
            fired, step = True, 50          # back to the step-50 checkpoint
            continue
        step += 1
    return out


def test_train_hrm_stream_strikes_the_same_bits_in_both(monkeypatch):
    """At lm-100m's full config the reference and the port draw the same
    strikes from the example's stream, among them bit 30 (a float32's top
    exponent bit) of ``params/head`` at step 17 and of
    ``params/blocks/mlp/wi`` at step 55. Only leaf shapes decide the draws,
    so the leaves are shapes (the reference) and untouched allocations
    (the port), protected under a policy with no tier, whose error model
    is ``detect_recover``'s."""
    policy = ("unprotected", {})
    assert JHRMPolicy(*policy).error_model == \
        JDESIGN_POINTS["detect_recover"]().error_model
    shapes = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0),
                                                 jget_config("lm-100m")))
    assert {s.dtype for s in jax.tree.leaves(shapes)} == {np.dtype("float32")}
    want = _train_hrm_strikes(JMemoryDomain.protect(
        {"params": shapes}, JHRMPolicy(*policy)), jops, monkeypatch)
    got = _train_hrm_strikes(MemoryDomain.protect(
        {"params": jax.tree.map(lambda s: torch.empty(s.shape), shapes)},
        HRMPolicy(*policy)), ops, monkeypatch)
    assert got == want
    top = [(step, path) for step, path, _, words, bits in got
           if any(w >= 0 and b % 32 == 30 for w, b in zip(words, bits))]
    assert len(got) == 29
    assert top == [(17, "params/head"), (55, "params/blocks/mlp/wi")]


def test_train_cli_prints_the_reference_counters(tmp_path, capsys,
                                                 monkeypatch):
    args = ["--tiny", "--policy", "detect_recover", "--error-rate", "0.5",
            "--fail-at", "8", "--steps", "16", "--scrub-interval", "4",
            "--ckpt-interval", "5"]
    assert train_cli.main(args + ["--device", CPU, "--ckpt-dir",
                                  str(tmp_path / "torch")]) == 0
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["train"] + args + [
        "--ckpt-dir", str(tmp_path / "jax")])
    jtrain_cli.main()
    want = capsys.readouterr().out.splitlines()
    assert got[0].startswith("steps=19 loss: ")
    # every counter but the wall-clock stragglers
    assert got[1].rsplit(" ", 1)[0] == want[1].rsplit(" ", 1)[0]
    assert "restarts=1" in got[1] and "injected=0" not in got[1]

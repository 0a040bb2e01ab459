"""The port's dense transformer forward against the JAX reference on the
CPU: the building blocks (RMSNorm, activations, RoPE), the synthetic LM
batches, and ``forward`` on tiny llama3-8b and tiny kvstore-demo with the
reference's parameters carried across through numpy.

Tolerances: with float32 compute the logits agree to 1e-4 x max|logit|
(the two frameworks sum the products in other orders); with bfloat16
compute to 3e-2 x max|logit| (bf16 keeps 8 bits of mantissa, and the two
round at other places), and the greedy tokens are equal wherever the
reference's top-2 margin exceeds that bound. The token batches are equal
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as jget_tiny
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.data import synthetic as jsyn
from repro.models import common as jcommon
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro_torch.configs import get_tiny
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import state_from_numpy
from repro_torch.data import synthetic
from repro_torch.models import common, forward
from repro_torch.models.transformer import dtype_of

CPU = "cpu"
ARCHS = ("llama3-8b", "kvstore-demo")
F32_REL = 1e-4
BF16_REL = 3e-2


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    want = jcommon.rmsnorm(jnp.asarray(x, jcommon.dtype_of(dtype)),
                           jnp.asarray(w), 1e-5)
    got = common.rmsnorm(_t(x).to(dtype_of(dtype)), _t(w), 1e-5)
    assert got.dtype == dtype_of(dtype)
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               rtol=1e-5 if dtype == "float32" else 1e-2,
                               atol=1e-6)


@pytest.mark.parametrize("name", ("swiglu", "relu2", "gelu"))
def test_activations_match_reference(name):
    """gelu is the tanh approximation, jax.nn.gelu's default."""
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = jcommon.act_fn(name)(jnp.asarray(x))
    got = common.act_fn(name)(_t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6,
                               atol=1e-6)


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="unknown activation"):
        common.act_fn("swish")


def test_rope_matches_reference():
    """Halves rotated (not interleaved pairs), in float32, cast back."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7)[None, :]
    np.testing.assert_allclose(
        common.rope_freqs(16, 5e5).numpy(), _np(jcommon.rope_freqs(16, 5e5)),
        rtol=1e-6)
    for dtype in ("float32", "bfloat16"):
        want = jcommon.apply_rope(jnp.asarray(x, jcommon.dtype_of(dtype)),
                                  jnp.asarray(pos), 5e5)
        got = common.apply_rope(_t(x).to(dtype_of(dtype)), _t(pos), 5e5)
        assert got.dtype == dtype_of(dtype)
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   rtol=1e-5 if dtype == "float32" else 1e-2,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_batch_equal_reference(arch):
    cfg, jcfg = get_tiny(arch), jget_tiny(arch)
    got = synthetic.lm_batch(cfg, 3, 40, 7, device=CPU)
    want = jsyn.lm_batch(jcfg, 3, 40, 7)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int64
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    shape = ShapeSpec("c", 32, 2, "train")
    got = synthetic.make_batch(cfg, shape, seed=3, device=CPU)
    want = jsyn.make_batch(jcfg, JShapeSpec("c", 32, 2, "train"), seed=3)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    stream = synthetic.batch_stream(cfg, 2, 16, seed=5, device=CPU)
    jstream = jsyn.batch_stream(jcfg, 2, 16, seed=5)
    for _ in range(2):
        np.testing.assert_array_equal(next(stream)["labels"].numpy(),
                                      np.asarray(next(jstream)["labels"]))


def test_make_batch_of_other_frontends_raises():
    """The frontend, not the family, picks the batch: tiny llama3-8b under
    the audio and vision frontends gets the reference's frames or patches;
    a sequence with no room for text after the patches raises in both."""
    for frontend, kw in (("audio_frames", {}),
                         ("vision_patches", {"n_patches": 5})):
        cfg = get_tiny("llama3-8b").replace(frontend=frontend, **kw)
        jcfg = jget_tiny("llama3-8b").replace(frontend=frontend, **kw)
        got = synthetic.make_batch(cfg, ShapeSpec("c", 8, 2, "train"),
                                   seed=4, device=CPU)
        want = jsyn.make_batch(jcfg, JShapeSpec("c", 8, 2, "train"), seed=4)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(AssertionError):
        jsyn.make_batch(jcfg, JShapeSpec("c", 5, 1, "train"))
    with pytest.raises(ValueError, match="no text"):
        synthetic.make_batch(cfg, ShapeSpec("c", 5, 1, "train"), device=CPU)


def _pair(arch: str, compute_dtype: str, **kw):
    """(reference cfg, port cfg, reference params, port params, reference
    batch, port batch) on the reference's seed-0 parameters."""
    jcfg = jget_tiny(arch).replace(compute_dtype=compute_dtype, **kw)
    cfg = get_tiny(arch).replace(compute_dtype=compute_dtype, **kw)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    p = state_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    return (jcfg, cfg, jp, p, jsyn.lm_batch(jcfg, 2, 32, 0),
            synthetic.lm_batch(cfg, 2, 32, 0, device=CPU))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_float32_matches_reference(arch):
    jcfg, cfg, jp, p, jb, b = _pair(arch, "float32")
    want, jaux, jcache = jforward(jp, jb, jcfg, return_cache=True)
    got, aux, cache = forward(p, b, cfg, return_cache=True)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    bound = F32_REL * np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= bound
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    assert float(aux) == float(jaux) == 0.0
    for k in ("k", "v"):
        w = np.asarray(jcache[k])
        assert tuple(cache[k].shape) == w.shape        # (L, B, S, K, dh)
        assert np.abs(cache[k].numpy() - w).max() <= \
            F32_REL * np.abs(w).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bfloat16_matches_reference(arch):
    """The configs' own compute dtype: logits within 3e-2 x max|logit|,
    greedy tokens equal wherever the reference's top-2 margin exceeds that
    bound."""
    jcfg, cfg, jp, p, jb, b = _pair(arch, "bfloat16")
    want = np.asarray(jforward(jp, jb, jcfg)[0].astype(jnp.float32))
    got = forward(p, b, cfg)[0]
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    bound = BF16_REL * np.abs(want).max()
    assert np.abs(got - want).max() <= bound
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > bound
    assert clear.mean() > 0.25          # the comparison is not vacuous
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


def test_forward_tied_embeddings_and_bias_match_reference():
    """The head reads ``embed.T`` when the embeddings are tied; the QKV
    biases are added in the compute dtype."""
    jcfg, cfg, jp, p, jb, b = _pair("llama3-8b", "float32",
                                    tie_embeddings=True, qkv_bias=True,
                                    act="relu2")
    assert "head" not in p and "bq" in p["blocks"]["attn"]
    want = np.asarray(jforward(jp, jb, jcfg)[0])
    got = forward(p, b, cfg)[0].numpy()
    assert np.abs(got - want).max() <= F32_REL * np.abs(want).max()


def test_forward_of_other_families_raises():
    """Where the reference's ``forward`` fails, the port's fails alike: the
    vlm family on a tree with no blocks, the vision frontend on a batch
    with no patches (``KeyError`` naming the missing key) and an unknown
    family (``ValueError``)."""
    cfg, jcfg = get_tiny("llama3-8b"), jget_tiny("llama3-8b")
    p = {"embed": torch.zeros(4, 2)}
    jp = {"embed": jnp.zeros((4, 2))}
    tokens = {"tokens": torch.zeros(1, 2, dtype=torch.int64)}
    jtokens = {"tokens": jnp.zeros((1, 2), jnp.int32)}
    for kw in ({"family": "vlm"}, {"frontend": "vision_patches"},
               {"family": "bogus"}):
        with pytest.raises((KeyError, ValueError)) as want:
            jforward(jp, jtokens, jcfg.replace(**kw))
        with pytest.raises(want.type) as got:
            forward(p, tokens, cfg.replace(**kw))
        assert got.value.args == want.value.args, kw

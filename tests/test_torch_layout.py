"""Packed word layout of the PyTorch port against the JAX reference:
``pack_words``/``unpack_words``/``words_per_tensor`` give the same 64-bit
words, bit for bit, for every supported dtype, ragged lengths and 0-d
leaves; unpacking inverts packing on both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.kernels import _build
from repro_torch.kernels import ops

DTYPES = ["float32", "bfloat16", "float16", "int32", "uint8", "int8"]
# ragged lengths, a 0-d leaf, and one leaf past BLOCK_ROWS rows (rounded up)
SHAPES = [(), (1,), (7,), (3, 5), (2, 3, 17), (300 * 256 + 5,)]


def _sample(dtype: str, shape, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype in ("float32", "float16", "bfloat16"):
        x = rng.standard_normal(shape).astype(np.float32)
        return np.asarray(jnp.asarray(x, dtype=jnp.dtype(dtype)))
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=shape, endpoint=True,
                        dtype=dtype)


def _ref_words(x: np.ndarray) -> np.ndarray:
    """The reference's packed (lo, hi) lanes as one int64 word each."""
    p = jops.pack_words(jnp.asarray(x))
    lo = np.asarray(p.lo).astype(np.uint64)
    hi = np.asarray(p.hi).astype(np.uint64)
    return (lo | (hi << np.uint64(32))).view(np.int64)


def _bytes(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _to_port(x: np.ndarray) -> torch.Tensor:
    return state_from_numpy({"x": x}, device="cpu")["x"]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_words_matches_reference(dtype, shape):
    x = _sample(dtype, shape)
    t = _to_port(x)
    words = ops.pack_words(t)
    assert words.dtype == torch.int64 and words.shape[1] == ops.LANES
    assert ops.words_per_tensor(t) == jops.words_per_tensor(jnp.asarray(x))
    assert words.numel() == ops.words_per_tensor(t)
    np.testing.assert_array_equal(words.numpy(), _ref_words(x))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_unpack_words_roundtrip(dtype, shape):
    x = _sample(dtype, shape, seed=1)
    t = _to_port(x)
    back = ops.unpack_words(ops.pack_words(t), t.shape, t.dtype)
    assert back.shape == t.shape and back.dtype == t.dtype
    assert np.array_equal(_bytes(state_to_numpy({"x": back})["x"]), _bytes(x))
    # unpacking the reference's words gives the reference's leaf
    ref_words = torch.from_numpy(_ref_words(x))
    ref_back = jops.unpack_words(jops.pack_words(jnp.asarray(x)), x.shape,
                                 x.dtype)
    port_back = ops.unpack_words(ref_words, t.shape, t.dtype)
    assert np.array_equal(_bytes(state_to_numpy({"x": port_back})["x"]),
                          _bytes(np.asarray(ref_back)))


def test_round_rows_matches_reference():
    for rows in (0, 1, 127, 128, 129, 255, 256, 1000):
        assert ops._round_rows(rows) == jops._round_rows(rows)
    assert ops.LANES == jops.LANES == _build.ROW_WORDS
    assert ops.BLOCK_ROWS == jops.BLOCK_ROWS


def test_pack_words_into_rejects_overflow_and_zeroes_tail():
    out = torch.full((1, ops.LANES), -1, dtype=torch.int64)
    ops.pack_words_into(out, torch.ones(3, dtype=torch.int32))
    assert out[0, 0].item() == 1 | (1 << 32) and out[0, 1].item() == 1
    assert not out[0, 2:].any()
    with pytest.raises(ValueError):
        ops.pack_words_into(out, torch.zeros(ops.LANES * 2 + 1,
                                             dtype=torch.int32))


def test_unpack_is_a_view_of_the_words():
    t = torch.arange(10, dtype=torch.float32)
    words = ops.pack_words(t)
    back = ops.unpack_words(words, t.shape, t.dtype)
    assert back.data_ptr() == words.data_ptr()


# ------------------------------------------------ per-leaf kernel wrappers
def test_per_leaf_wrappers_match_reference():
    x = _sample("bfloat16", (3, 700), seed=5)
    t = _to_port(x)
    jx = jnp.asarray(x)
    ecc = ops.secded_encode(t)
    np.testing.assert_array_equal(ecc.numpy(),
                                  np.asarray(jops.secded_encode(jx)))
    par = ops.parity_encode(t)
    np.testing.assert_array_equal(par.numpy(),
                                  np.asarray(jops.parity_encode(jx)))
    wi = np.array([0, 5, 5, 9, 300, -1, 0, 0], np.int32)
    bi = np.array([1, 2, 40, 63, 7, 0, 9, 9], np.int32)
    jbad = jops.inject_bitflips(jx, jnp.asarray(wi), jnp.asarray(bi))
    bad = ops.inject_bitflips(t, torch.from_numpy(wi), torch.from_numpy(bi))
    assert np.array_equal(_bytes(state_to_numpy({"x": bad})["x"]),
                          _bytes(np.asarray(jbad)))
    jfix, jecc, jc, ju = jops.secded_scrub(jbad, jnp.asarray(ecc.numpy()))
    fix, ecc2, c, u = ops.secded_scrub(bad, ecc)
    assert np.array_equal(_bytes(state_to_numpy({"x": fix})["x"]),
                          _bytes(np.asarray(jfix)))
    np.testing.assert_array_equal(ecc2.numpy(), np.asarray(jecc))
    assert (int(c), int(u)) == (int(jc), int(ju))
    jpar = jnp.asarray(par.numpy())
    assert int(ops.parity_check(bad, par)) == int(jops.parity_check(jbad,
                                                                     jpar))
    mask = ops.parity_error_words(bad, par)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(
        jops.parity_error_words(jbad, jpar)))
    back = ops.restore_words(bad, t, mask)
    jback = jops.restore_words(jbad, jx, jnp.asarray(mask.numpy()))
    assert np.array_equal(_bytes(state_to_numpy({"x": back})["x"]),
                          _bytes(np.asarray(jback)))

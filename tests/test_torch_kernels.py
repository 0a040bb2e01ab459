"""Tier kernels of the PyTorch port against ``repro.kernels.ref``, bit for
bit: SEC-DED encode/scrub (every single-bit strike on a few words, sampled
double-bit strikes), parity encode/check, and bit-flip injection with
inactive, out-of-range and duplicate strikes.

On the CPU the wrappers run the plain versions; ``chip_smoke.py`` holds
the CUDA kernels against them on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import hsiao as jhsiao
from repro.kernels import ref as jref
from repro_torch.kernels import _build, hsiao, ref
from repro_torch.kernels.bitflip import bitflip_words_
from repro_torch.kernels.parity import parity_check_words, parity_encode_words
from repro_torch.kernels.secded import secded_encode_words, secded_scrub_words

LANES = 256


def _random_words(rng, n: int) -> np.ndarray:
    return rng.integers(0, 2**64, size=n, dtype=np.uint64, endpoint=False)


def _lanes(words: np.ndarray):
    """uint64 words -> the reference's (lo, hi) uint32 lanes."""
    return (jnp.asarray((words & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((words >> np.uint64(32)).astype(np.uint32)))


def _words(lo, hi) -> np.ndarray:
    lo = np.asarray(lo).astype(np.uint64)
    hi = np.asarray(hi).astype(np.uint64)
    return lo | (hi << np.uint64(32))


def _port(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int64).reshape(-1, LANES).copy())


def _flip(words: np.ndarray, ecc: np.ndarray, word: int, bit: int) -> None:
    """Flip data bit ``bit`` < 64, or check bit ``bit - 64``, of a word."""
    if bit < 64:
        words[word] ^= np.uint64(1) << np.uint64(bit)
    else:
        ecc[word] ^= np.uint8(1 << (bit - 64))


def _strikes(rng, n_rows: int, n_bits: int):
    """Clean words with one row per case: every single-bit strike (72
    positions) on three words, or ``n_rows*256`` sampled double strikes."""
    words = _random_words(rng, n_rows * LANES)
    ecc = np.asarray(jref.secded_encode_ref(*_lanes(words))).astype(np.uint8)
    if n_bits == 1:
        bits = [b for b in range(72) for _ in range(3)]
        for i, bit in enumerate(bits):
            _flip(words, ecc, i, bit)
    else:
        for i in range(words.size):
            a, b = rng.choice(72, size=2, replace=False)
            _flip(words, ecc, i, int(a))
            _flip(words, ecc, i, int(b))
    return words, ecc


def test_tables_are_the_reference_tables():
    for name in ("DATA_COLS", "CHECK_COLS", "MASK_LO", "MASK_HI",
                 "SYNDROME_ACTION"):
        np.testing.assert_array_equal(getattr(hsiao, name),
                                      getattr(jhsiao, name))


def test_secded_encode_matches_reference():
    words = _random_words(np.random.default_rng(0), 64 * LANES)
    want = np.asarray(jref.secded_encode_ref(*_lanes(words))).astype(np.uint8)
    got = secded_encode_words(_port(words))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy().reshape(-1), want)


@pytest.mark.parametrize("n_bits", [0, 1, 2])
def test_secded_scrub_matches_reference(n_bits):
    rng = np.random.default_rng(10 + n_bits)
    if n_bits == 0:
        words = _random_words(rng, 4 * LANES)
        ecc = np.asarray(jref.secded_encode_ref(*_lanes(words))).astype(
            np.uint8)
    else:
        words, ecc = _strikes(rng, 4, n_bits)
    lo2, hi2, ecc2, corr, unc = jref.secded_scrub_ref(
        *_lanes(words), jnp.asarray(ecc.astype(np.uint32)))
    w, e = _port(words), torch.from_numpy(ecc.reshape(-1, LANES).copy())
    pw, pe, pc, pu = ref.secded_scrub_ref(w, e)
    np.testing.assert_array_equal(pw.numpy().reshape(-1).view(np.uint64),
                                  _words(lo2, hi2))
    np.testing.assert_array_equal(pe.numpy().reshape(-1),
                                  np.asarray(ecc2).astype(np.uint8))
    np.testing.assert_array_equal(pc.numpy().reshape(-1), np.asarray(corr))
    np.testing.assert_array_equal(pu.numpy().reshape(-1), np.asarray(unc))
    # the wrapper's per-row counts are the masks' row sums
    ww, we, wc, wu = secded_scrub_words(w, e)
    assert torch.equal(ww, pw) and torch.equal(we, pe)
    np.testing.assert_array_equal(
        wc.numpy(), np.asarray(corr).reshape(-1, LANES).sum(1))
    np.testing.assert_array_equal(
        wu.numpy(), np.asarray(unc).reshape(-1, LANES).sum(1))
    assert wc.dtype == wu.dtype == torch.int32
    if n_bits == 1:
        assert int(wc.sum()) == 3 * 72 and int(wu.sum()) == 0
    if n_bits == 2:
        assert int(wu.sum()) == words.size and int(wc.sum()) == 0


def test_parity_encode_and_check_match_reference():
    rng = np.random.default_rng(3)
    clean = _random_words(rng, 8 * LANES)
    par = np.asarray(jref.parity_encode_ref(
        *(a.reshape(-1, LANES) for a in _lanes(clean)))).astype(np.uint8)
    got = parity_encode_words(_port(clean))
    np.testing.assert_array_equal(got.numpy(), par)
    # single flips on some words, double flips (undetectable) on others
    words = clean.copy()
    for i in rng.choice(words.size, size=300, replace=False):
        bits = rng.choice(64, size=1 + int(i) % 2, replace=False)
        for b in bits:
            words[i] ^= np.uint64(1) << np.uint64(b)
    mask = np.asarray(jref.parity_check_ref(
        *(a.reshape(-1, LANES) for a in _lanes(words)), jnp.asarray(par)))
    t_par = torch.from_numpy(par)
    np.testing.assert_array_equal(
        ref.parity_check_ref(_port(words), t_par).numpy(), mask)
    err, cnt = parity_check_words(_port(words), t_par)
    np.testing.assert_array_equal(ref.unpack_bits(err).numpy(), mask)
    np.testing.assert_array_equal(cnt.numpy(), mask.sum(1))
    assert err.dtype == torch.uint8 and cnt.dtype == torch.int32


def test_bitflip_matches_reference():
    rng = np.random.default_rng(4)
    n = 4 * LANES
    words = _random_words(rng, n)
    wi = rng.integers(0, n, size=48).astype(np.int32)
    bi = rng.integers(0, 64, size=48).astype(np.int32)
    wi[:6] = -1                               # inactive slots
    wi[6:9] = [n, n + 5, 2**31 - 1]           # out of range: dropped
    wi[9:12] = wi[20]                         # strike 20 four times ...
    bi[9:12] = bi[20]                         # ... an even number: cancels
    wi[12:14] = wi[21]                        # strike 21 three times: flips
    bi[12:14] = bi[21]
    wi[14], bi[14] = wi[30], (bi[30] + 1) % 64   # same word, another bit
    lo, hi = jref.bitflip_ref(*_lanes(words), jnp.asarray(wi),
                              jnp.asarray(bi))
    want = _words(lo, hi)
    got = ref.bitflip_ref(_port(words), torch.from_numpy(wi),
                          torch.from_numpy(bi))
    np.testing.assert_array_equal(got.numpy().reshape(-1).view(np.uint64),
                                  want)
    buf = _port(words)
    assert bitflip_words_(buf, wi, bi) is buf
    assert torch.equal(buf, got)


def test_bitflip_drops_bits_outside_the_word():
    words = torch.zeros((1, LANES), dtype=torch.int64)
    bitflip_words_(words, [0, 1, 2, 3], [-1, 64, 63, 0])
    assert words[0, :2].tolist() == [0, 0]
    assert words[0, 2].item() == -(2**63) and words[0, 3].item() == 1


def test_wrappers_check_their_inputs():
    words = torch.zeros((2, LANES), dtype=torch.int64)
    with pytest.raises(ValueError):
        secded_encode_words(words.to(torch.int32))
    with pytest.raises(ValueError):
        secded_encode_words(torch.zeros((2, 128), dtype=torch.int64))
    with pytest.raises(ValueError):
        secded_encode_words(torch.zeros((LANES, 2), dtype=torch.int64).t())
    with pytest.raises(ValueError):
        secded_scrub_words(words, torch.zeros((2, LANES), dtype=torch.int32))
    with pytest.raises(ValueError):
        parity_check_words(words, torch.zeros((3, 32), dtype=torch.uint8))
    with pytest.raises(ValueError):
        bitflip_words_(words, [0, 1], [0])
    with pytest.raises(ValueError):
        _build.on_card(torch.zeros(1, device="meta"))


def test_cpu_tensors_launch_nothing():
    before = dict(_build.LAUNCHES)
    words = torch.zeros((1, LANES), dtype=torch.int64)
    ecc = secded_encode_words(words)
    secded_scrub_words(words, ecc)
    parity_check_words(words, parity_encode_words(words))
    bitflip_words_(words, [0], [0])
    assert _build.LAUNCHES == before

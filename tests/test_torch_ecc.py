"""The DEC-TED, BCH and burst codes of the PyTorch port against the JAX
reference, bit for bit: the ``make_code`` tables field by field, and the
plain encode and scrub against ``repro.kernels.ref`` on random words, with
every single and every double strike over the 79 DEC-TED codeword bits,
sampled triples, and every adjacent data pair for BURST. The per-leaf
wrappers of ``kernels/ops.py`` against ``repro.kernels.ops``.

Codeword positions follow ``tests/ecc_conformance.py``: 0..63 are data bits,
64.. the sidecar's check bits. On the CPU the wrappers run the plain
versions; ``chip_smoke.py`` holds the CUDA kernels against them on a card."""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HRMPolicy as JPolicy
from repro.core import MemoryDomain as JDomain
from repro.core import Tier as JTier
from repro.core.errormodel import InjectionPlan as JPlan
from repro.kernels import bch as jbch
from repro.kernels import burst as jburst
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.dected import DECTED_CODE as JDECTED
from repro_torch.convert import sidecar_to_numpy
from repro_torch.core import HRMPolicy, InjectionPlan, MemoryDomain, Tier
from repro_torch.kernels import _build, bch, burst, ops, ref
from repro_torch.kernels.dected import (DECTED_CODE, N_CHECK,
                                        dected_encode_words,
                                        dected_scrub_words)

LANES = 256
CODES = {"dected": (64, 2, 7, True), "bch72": (64, 1, 7, True),
         "burst_sub": (32, 1, 6, True), "bch_t2_noparity": (64, 2, 7, False)}


def _random_words(rng, n: int) -> np.ndarray:
    return rng.integers(0, 2**64, size=n, dtype=np.uint64)


def _lanes(words: np.ndarray):
    return (jnp.asarray((words & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((words >> np.uint64(32)).astype(np.uint32)))


def _words(lo, hi) -> np.ndarray:
    return np.asarray(lo).astype(np.uint64) | (
        np.asarray(hi).astype(np.uint64) << np.uint64(32))


def _port(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int64).reshape(-1, LANES).copy())


def _port_ecc(ecc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(ecc.astype(np.uint16).reshape(-1, LANES).copy())


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().reshape(-1).view(np.uint64)


def _padded(patterns, rng):
    """One word per pattern, padded with clean words to whole rows."""
    n = -(-len(patterns) // LANES) * LANES
    return list(patterns) + [()] * (n - len(patterns)), _random_words(rng, n)


def _strike(words: np.ndarray, ecc: np.ndarray, patterns, k: int):
    """Apply pattern i (codeword positions) to word i: data bit p < k of
    the word, else check bit p - 64."""
    words, ecc = words.copy(), ecc.copy()
    for i, pat in enumerate(patterns):
        for p in pat:
            if p < 64:
                assert p < k
                words[i] ^= np.uint64(1) << np.uint64(p)
            else:
                ecc[i] ^= 1 << (p - 64)
    return words, ecc


def _scrub_both(jscrub, tref, twrap, words, ecc):
    """Reference, port plain version (per-word flags) and port wrapper
    (per-row counts) on the same struck words; asserts equal outputs and
    returns the per-word (corrected, uncorrectable, words')."""
    lo2, hi2, ecc2, corr, unc = jscrub(*_lanes(words),
                                       jnp.asarray(ecc.astype(np.uint32)))
    corr, unc = np.asarray(corr), np.asarray(unc)
    w, e = _port(words), _port_ecc(ecc)
    w2, e2, c, u = tref(w, e)
    assert e2.dtype == torch.uint16
    np.testing.assert_array_equal(_u64(w2), _words(lo2, hi2))
    np.testing.assert_array_equal(e2.to(torch.int64).numpy().reshape(-1),
                                  np.asarray(ecc2))
    np.testing.assert_array_equal(c.numpy().reshape(-1), corr)
    np.testing.assert_array_equal(u.numpy().reshape(-1), unc)
    ww, we, wc, wu = twrap(w, e)
    assert torch.equal(ww, w2) and torch.equal(we.view(torch.int16),
                                               e2.view(torch.int16))
    assert wc.dtype == wu.dtype == torch.int32
    np.testing.assert_array_equal(wc.numpy(), corr.reshape(-1, LANES).sum(1))
    np.testing.assert_array_equal(wu.numpy(), unc.reshape(-1, LANES).sum(1))
    return corr, unc, _u64(w2)


# ----------------------------------------------------------------- tables
@pytest.mark.parametrize("name", sorted(CODES))
def test_make_code_tables_are_the_reference_tables(name):
    got = dataclasses.asdict(bch.make_code(*CODES[name]))
    want = dataclasses.asdict(jbch.make_code(*CODES[name]))
    assert got.keys() == want.keys()
    for field in want:
        assert got[field] == want[field], field
    assert bch.make_code(*CODES[name]).d_min == \
        jbch.make_code(*CODES[name]).d_min


def test_dected_and_burst_tables_are_the_reference_tables():
    assert dataclasses.asdict(DECTED_CODE) == dataclasses.asdict(JDECTED)
    assert N_CHECK == 15 and burst.N_SUB == 7 and burst.N_CHECK == 14
    assert dataclasses.asdict(burst.SUB_CODE) == \
        dataclasses.asdict(jburst.SUB_CODE)
    assert burst._MASKS == jburst._MASKS
    for offset in (0, 1):
        assert burst._spread_masks(offset) == jburst._spread_masks(offset)


# ------------------------------------------------------------------- BCH
@pytest.mark.parametrize("name", sorted(CODES))
def test_bch_encode_matches_reference(name):
    words = _random_words(np.random.default_rng(1), 16 * LANES)
    jcode, tcode = jbch.make_code(*CODES[name]), bch.make_code(*CODES[name])
    want = np.asarray(jref.bch_encode_ref(jcode, *_lanes(words)))
    got = bch.bch_encode_words(_port(words), tcode)
    assert got.dtype == torch.uint16 and got.shape == (16, LANES)
    np.testing.assert_array_equal(got.to(torch.int64).numpy().reshape(-1),
                                  want)


def _bch_case(name, n_bits, rng):
    jcode, tcode = jbch.make_code(*CODES[name]), bch.make_code(*CODES[name])
    positions = list(range(tcode.k)) + [64 + j for j in range(tcode.r)]
    if n_bits <= 2:
        pats = list(itertools.combinations(positions, n_bits))
    else:
        pats = [tuple(rng.choice(positions, size=3, replace=False))
                for _ in range(1024)]
    pats, words = _padded(pats, rng)
    ecc = np.asarray(jref.bch_encode_ref(jcode, *_lanes(words)))
    bad, bad_ecc = _strike(words, ecc, pats, tcode.k)
    corr, unc, fixed = _scrub_both(
        lambda lo, hi, e: jref.bch_scrub_ref(jcode, lo, hi, e),
        lambda w, e: ref.bch_scrub_ref(w, e, tcode),
        lambda w, e: bch.bch_scrub_words(w, e, tcode), bad, bad_ecc)
    struck = np.array([len(p) > 0 for p in pats])
    return tcode, struck, corr, unc, fixed == words


@pytest.mark.parametrize("n_bits", [1, 2, 3])
def test_dected_scrub_matches_reference(n_bits):
    """DEC-TED corrects every 1- and every 2-bit pattern over its 79
    codeword bits, and flags sampled 3-bit patterns, never miscorrecting."""
    code, struck, corr, unc, restored = _bch_case(
        "dected", n_bits, np.random.default_rng(20 + n_bits))
    assert code.n == 79 and struck.sum() == (79, 3081, 1024)[n_bits - 1]
    if n_bits <= 2:
        assert corr[struck].all() and not unc.any() and restored.all()
    else:
        assert unc[struck].all() and not corr.any()
    assert restored[~struck].all() and not corr[~struck].any()


@pytest.mark.parametrize("name,n_bits", [("bch72", 1), ("bch72", 2),
                                         ("burst_sub", 1),
                                         ("bch_t2_noparity", 2)])
def test_other_bch_codes_scrub_matches_reference(name, n_bits):
    """The t=1 instances correct singles and flag doubles; t=2 without the
    parity factor corrects doubles through the non-matching branch."""
    code, struck, corr, unc, restored = _bch_case(
        name, n_bits, np.random.default_rng(30 + n_bits))
    if n_bits == 1 or code.t == 2:
        assert corr[struck].all() and restored.all()
    else:
        assert unc[struck].all() and not corr.any()


# ----------------------------------------------------------------- burst
def test_burst_encode_matches_reference():
    words = _random_words(np.random.default_rng(2), 16 * LANES)
    want = np.asarray(jref.burst_encode_ref(*_lanes(words)))
    got = burst.burst_encode_words(_port(words))
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.to(torch.int64).numpy().reshape(-1),
                                  want)


@pytest.mark.parametrize("kind", ["single", "adjacent", "random_double",
                                  "triple"])
def test_burst_scrub_matches_reference(kind):
    """Every single (78 positions) and every adjacent data pair (63) is
    corrected; random doubles and triples match the reference word for
    word (corrected where they split across the sub-codes, else
    flagged)."""
    rng = np.random.default_rng({"single": 40, "adjacent": 41,
                                 "random_double": 42, "triple": 43}[kind])
    positions = list(range(64 + burst.N_CHECK))
    if kind == "single":
        pats = [(p,) for p in positions]
    elif kind == "adjacent":
        pats = [(b, b + 1) for b in range(63)]
    else:
        size = 2 if kind == "random_double" else 3
        pats = [tuple(rng.choice(positions, size=size, replace=False))
                for _ in range(1024)]
    pats, words = _padded(pats, rng)
    ecc = np.asarray(jref.burst_encode_ref(*_lanes(words)))
    bad, bad_ecc = _strike(words, ecc, pats, 64)
    corr, unc, fixed = _scrub_both(
        jref.burst_scrub_ref,
        lambda w, e: ref.burst_scrub_ref(w, e, burst.MASK_LO, burst.MASK_HI,
                                         burst.SUB_CODE),
        burst.burst_scrub_words, bad, bad_ecc)
    struck = np.array([len(p) > 0 for p in pats])
    if kind in ("single", "adjacent"):
        assert corr[struck].all() and not unc.any()
        assert (fixed == words).all()
    elif kind == "random_double":
        # split across the sub-codes: corrected; within one: flagged
        assert (corr ^ unc)[struck].all()
        assert (fixed[corr] == words[corr]).all()
    assert (fixed[unc] == bad[unc]).all()           # flagged: untouched


# ------------------------------------------------------- wrappers, ops
def test_wrappers_reject_a_wrong_sidecar():
    words = torch.zeros((2, LANES), dtype=torch.int64)
    for bad in (torch.zeros((2, LANES), dtype=torch.uint8),
                torch.zeros((2, LANES), dtype=torch.int16),
                torch.zeros((3, LANES), dtype=torch.uint16),
                torch.zeros((LANES, 2), dtype=torch.uint16).t()):
        with pytest.raises(ValueError):
            dected_scrub_words(words, bad)
        with pytest.raises(ValueError):
            burst.burst_scrub_words(words, bad)
        with pytest.raises(ValueError):
            bch.bch_scrub_words(words, bad, bch.make_code(64, 1, 7))
    with pytest.raises(ValueError):
        dected_encode_words(words.to(torch.int32))
    with pytest.raises(ValueError):                  # r = 17 > 16 bits
        bch.bch_encode_words(words, bch.make_code(64, 2, 8))


def test_cpu_tensors_launch_nothing():
    before = dict(_build.LAUNCHES)
    words = torch.zeros((1, LANES), dtype=torch.int64)
    dected_scrub_words(words, dected_encode_words(words))
    burst.burst_scrub_words(words, burst.burst_encode_words(words))
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("tier", ["dected", "burst"])
def test_leaf_wrappers_match_reference(tier):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((37, 129)).astype(np.float32)
    jenc, jscrub = getattr(jops, tier + "_encode"), getattr(jops,
                                                             tier + "_scrub")
    tenc, tscrub = getattr(ops, tier + "_encode"), getattr(ops,
                                                           tier + "_scrub")
    want_ecc = np.asarray(jenc(jnp.asarray(x)))
    got_ecc = tenc(torch.from_numpy(x))
    assert got_ecc.dtype == torch.uint16 and want_ecc.dtype == np.uint16
    np.testing.assert_array_equal(got_ecc.numpy(), want_ecc)
    bad = x.copy().reshape(-1).view(np.uint32)
    bad[::97] ^= np.uint32(3) << np.uint32(7)        # adjacent pairs
    bad = bad.view(np.float32).reshape(x.shape)
    jx, jecc2, jc, ju = jscrub(jnp.asarray(bad), jnp.asarray(want_ecc))
    tx, tecc2, tc, tu = tscrub(torch.from_numpy(bad), got_ecc)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tecc2.numpy(), np.asarray(jecc2))
    assert (int(tc), int(tu)) == (int(jc), int(ju)) == (bad.size // 97 + 1, 0)
    np.testing.assert_array_equal(tx.numpy(), x)


# ---------------------------------------------------------------- system
@pytest.mark.parametrize("tier", ["parity_r", "secded", "burst", "dected"])
def test_adjacent_burst_storm_matches_reference(tier):
    """Six adjacent double-bit bursts in distinct words of one leaf: silent
    under parity, detected and stuck under SEC-DED, healed by ``scrub``
    alone under BURST and DEC-TED, the same outcome on both sides."""
    w = np.arange(4096, dtype=np.float32)
    jdom = JDomain.protect({"w": jnp.asarray(w)},
                           JPolicy("storm", {}, default=JTier(tier)))
    tdom = MemoryDomain.protect({"w": torch.from_numpy(w.copy())},
                                HRMPolicy("storm", {}, default=Tier(tier)))
    n_words = tdom.spec.by_path["w"].rows * 256
    jplan = JPlan.adjacent_burst(np.random.default_rng(0), n_words, 6)
    tplan = InjectionPlan.adjacent_burst(np.random.default_rng(0), n_words, 6)
    jfix, jrep = jdom.apply_plan("w", jplan).scrub()
    tfix, trep = tdom.apply_plan("w", tplan).scrub()
    np.testing.assert_array_equal(tfix.leaf("w").numpy(),
                                  np.asarray(jfix.leaf("w")))
    want = jax.tree.map(np.asarray, jfix.sidecar)[tier]
    got = sidecar_to_numpy(tfix.sidecar)[tier]
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name])
    assert trep.totals() == jrep.totals()
    healed = np.array_equal(tfix.leaf("w").numpy(), w)
    assert healed == (tier in ("burst", "dected"))
    assert trep.totals() == {"parity_r": (0, 0), "secded": (0, 6),
                             "burst": (6, 0), "dected": (6, 0)}[tier]

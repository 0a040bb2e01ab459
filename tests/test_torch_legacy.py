"""The legacy per-leaf API of the port (``core.sidecar``'s
``build_sidecar``/``scrub``, ``Scrubber``, ``Injector``,
``RecoveryManager``) against the JAX reference on the CPU.

The same small state (five leaves over the embed, attention, MLP and norm
regions, one of them bf16, moved across through numpy), policy and numpy
seed give the same warnings, the same sidecar bytes path for path under
each tier, the same strikes (path, word and bit), the same scrub reports
and repaired leaves, the same round-robin passes, and the same recovery
events, strike counts and retired blocks. The reference's kernels run in
Pallas interpret mode, as its own tests run them; the port's run their
plain versions on the CPU.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import Injector as JInjector
from repro.core import Scrubber as JScrubber
from repro.core import build_sidecar as jbuild_sidecar
from repro.core import scrub as jscrub
from repro.core import sidecar_bytes as jsidecar_bytes
from repro.core import state_bytes as jstate_bytes
from repro.core.policy import DESIGN_POINTS as JDESIGN_POINTS
from repro.core.recovery import RecoveryManager as JRecoveryManager
from repro.core.recovery import Response as JResponse
from repro.core.recovery import RestartRequired as JRestartRequired
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import (DESIGN_POINTS, Injector, RecoveryManager,
                              Response, RestartRequired, Scrubber,
                              build_sidecar, scrub, sidecar_bytes,
                              state_bytes, typical_server)
from repro_torch.core import tree
from repro_torch.core.sidecar import leaf_index

POLICIES = ["typical_server", "detect_recover", "detect_recover_l",
            "mirror_dr_l", "dected_server", "burst_dr_l"]


@pytest.fixture(scope="module")
def jparams():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"embed": jnp.asarray(f32(64, 16)),
            "head": jnp.asarray(f32(16, 64)).astype(jnp.bfloat16),
            "blocks": {"attn": {"wq": jnp.asarray(f32(2, 16, 16))},
                       "mlp": {"wi": jnp.asarray(f32(2, 16, 24))},
                       "norm1": jnp.asarray(f32(2, 16))}}


def _port(jtree):
    return state_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")


def _np(x) -> np.ndarray:
    """A reference array or port tensor as bytes."""
    if not isinstance(x, (np.ndarray, jax.Array)):
        x = state_to_numpy({"x": x})["x"]
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _same_tree(jt, t):
    jl = jax.tree_util.tree_flatten_with_path(jt)[0]
    tl = tree.flatten_with_path(t)[0]
    assert [tuple(str(getattr(e, "key", e)) for e in p) for p, _ in jl] == \
        [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        assert np.array_equal(_np(a), _np(b)), p


def _same_sidecar(jsc, sc):
    assert list(jsc) == list(sc)
    for path in jsc:
        assert sorted(jsc[path]) == sorted(sc[path]), path
        for k, v in jsc[path].items():
            if k == "tier":
                assert sc[path][k] == v
            else:
                assert np.array_equal(_np(v), _np(sc[path][k])), (path, k)


def _counts(d):
    return {k: int(np.asarray(v)) for k, v in d.items()}


def _same_report(jrep, rep):
    assert _counts(jrep.corrected) == _counts(rep.corrected)
    assert _counts(jrep.detected_uncorrectable) == \
        _counts(rep.detected_uncorrectable)
    assert jrep.totals() == rep.totals()
    assert jrep.needs_recovery() == rep.needs_recovery()


def test_legacy_shims_emit_deprecation_warnings(jparams):
    params, policy = _port(jparams), typical_server()
    with pytest.warns(DeprecationWarning, match="legacy per-leaf"):
        sc = build_sidecar(params, policy)
    with pytest.warns(DeprecationWarning, match="legacy per-leaf"):
        scrub(params, sc, policy)
    with pytest.warns(DeprecationWarning, match="legacy per-leaf"):
        scr = Scrubber.create(params, policy)
    # the shim warns once at entry, not per delegated call
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        scr.scrub_now(params)


@pytest.mark.parametrize("name", POLICIES)
def test_sidecar_strikes_and_scrub_equal_reference(jparams, name):
    """Sidecar bytes for each tier, one soft strike (single-bit, or a
    double-bit burst) into each leaf from one seed, and the scrub's report
    and repaired leaves."""
    jpol, pol = JDESIGN_POINTS[name](), DESIGN_POINTS[name]()
    params = _port(jparams)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jsc = jbuild_sidecar(jparams, jpol)
        sc = build_sidecar(params, pol)
        _same_sidecar(jsc, sc)
        assert sidecar_bytes(sc) == jsidecar_bytes(jsc)
        assert state_bytes(params) == jstate_bytes(jparams)
        jinj, inj = JInjector.seeded(3), Injector.seeded(3)
        jbad, bad = jparams, params
        for i, path in enumerate(leaf_index(params)):
            kw = dict(n_errors=1, multi_bit_fraction=float(i % 2),
                      adjacent_fraction=1.0)
            jbad = jinj.sample_into(jbad, path, **kw)
            bad = inj.sample_into(bad, path, **kw)
        _same_tree(jbad, bad)
        jfixed, jsc2, jrep = jscrub(jbad, jsc, jpol)
        fixed, sc2, rep = scrub(bad, sc, pol)
    _same_report(jrep, rep)
    assert rep.totals() != (0, 0)
    _same_tree(jfixed, fixed)
    _same_sidecar(jsc2, sc2)


def test_injector_strikes_equal_reference(jparams):
    """Soft and hard plans from one seed: the same words and bits; hard
    strikes re-assert and ``clear`` drops them, as in the reference."""
    params = _port(jparams)
    jinj, inj = JInjector.seeded(11), Injector.seeded(11)
    jst, st = jparams, params
    for path, hard in (("embed", False), ("blocks/attn/wq", True),
                       ("head", True), ("blocks/mlp/wi", False)):
        jst = jinj.sample_into(jst, path, n_errors=3, hard=hard)
        st = inj.sample_into(st, path, n_errors=3, hard=hard)
    _same_tree(jst, st)
    assert [e.path for e in inj.live] == [e.path for e in jinj.live] == \
        ["blocks/attn/wq", "head"]
    for je, e in zip(jinj.live, inj.live):
        assert np.array_equal(je.plan.word_idx, e.plan.word_idx)
        assert np.array_equal(je.plan.bit_idx, e.plan.bit_idx)
    # re-asserting flips the sticky bits back (XOR), on both sides
    _same_tree(jinj.reassert_hard(jst), inj.reassert_hard(st))
    jinj.clear("head")
    inj.clear("head")
    assert [e.path for e in inj.live] == [e.path for e in jinj.live]
    inj.clear()
    assert inj.live == []


@pytest.mark.parametrize("stride", (1, 2, 3))
def test_scrubber_round_robin_equals_reference(jparams, stride):
    """``maybe_scrub`` on its schedule over a strided round robin, strikes
    landing between passes: the same passes, totals and repaired state."""
    jpol, pol = JDESIGN_POINTS["typical_server"](), typical_server()
    params = _port(jparams)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jscr = JScrubber.create(jparams, jpol, stride=stride)
        scr = Scrubber.create(params, pol, stride=stride)
    jinj, inj = JInjector.seeded(5), Injector.seeded(5)
    jst, st = jparams, params
    paths = list(leaf_index(params))
    for step in range(8):
        path = paths[step % len(paths)]
        jst = jinj.sample_into(jst, path, multi_bit_fraction=0.0)
        st = inj.sample_into(st, path, multi_bit_fraction=0.0)
        jst, jrep = jscr.maybe_scrub(step, jst)
        st, rep = scr.maybe_scrub(step, st)
        assert (jrep is None) == (rep is None)
        if rep is not None:
            _same_report(jrep, rep)
    assert scr.history == jscr.history and scr._pass_idx == jscr._pass_idx
    _same_tree(jst, st)
    scr.refresh(st, paths=["embed"])
    jscr.refresh(jst, paths=["embed"])
    _same_sidecar(jscr.sidecar, scr.sidecar)


@pytest.mark.parametrize("response", ("consume", "restart",
                                      "reload_clean_copy", "peer_copy"))
def test_recovery_manager_events_equal_reference(jparams, response):
    """Detect-and-recover (Par+R) on hard strikes, three rounds: the same
    events, strike counts and retired blocks, and the clean copies
    restored; ``restart`` raises on both sides."""
    jpol, pol = JDESIGN_POINTS["detect_recover"](), \
        DESIGN_POINTS["detect_recover"]()
    params = _port(jparams)
    jclean = {p: leaf for p, leaf in _jflat(jparams).items()}
    clean = {p: leaf for p, leaf in tree.flatten_with_path(params)[0]}
    clean = {"/".join(p): leaf for p, leaf in clean.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jscr = JScrubber.create(jparams, jpol)
        scr = Scrubber.create(params, pol)
        jrm = JRecoveryManager(jclean.__getitem__, JResponse(response))
        rm = RecoveryManager(clean.__getitem__, Response(response))
        jinj, inj = JInjector.seeded(7), Injector.seeded(7)
        jst = jinj.sample_into(jparams, "blocks/mlp/wi", n_errors=2,
                               hard=True, multi_bit_fraction=0.0)
        st = inj.sample_into(params, "blocks/mlp/wi", n_errors=2, hard=True,
                             multi_bit_fraction=0.0)
        for _ in range(3):
            jst, jrep = jscr.scrub_now(jst)
            st, rep = scr.scrub_now(st)
            _same_report(jrep, rep)
            if response == "restart":
                with pytest.raises(JRestartRequired):
                    jrm.respond(jst, jrep, jscr)
                with pytest.raises(RestartRequired):
                    rm.respond(st, rep, scr)
                break
            jst = jinj.reassert_hard(jrm.respond(jst, jrep, jscr))
            st = inj.reassert_hard(rm.respond(st, rep, scr))
    assert rm.events == jrm.events and rm.events
    assert rm.strike_counts == jrm.strike_counts
    assert rm.retirement.blocks == jrm.retirement.blocks
    _same_tree(jst, st)
    if response in ("reload_clean_copy", "peer_copy"):
        assert rm.retirement.count() > 0


def _jflat(t):
    return {"/".join(str(getattr(e, "key", e)) for e in p): x
            for p, x in jax.tree_util.tree_flatten_with_path(t)[0]}

"""``MemoryDomain`` of the PyTorch port against the JAX reference, byte for
byte: the same state (carried across through numpy), policy and numpy seed
give the same paths, leaf layout, sidecars, payload, per-path scrub counts,
hard-error map, recovery events and retired blocks, under the paper's
design points, the strong-ECC ``dected_server`` and ``burst_dr_l``, a mixed
NONE/PARITY_R/SECDED/MIRROR policy and a mixed policy with DECTED and BURST
regions, on a bare params tree and on a ``{params, kv_cache}`` state.

The JAX side runs as its own tests run it: Pallas in interpret mode on the
CPU. The port runs its plain kernel versions on the CPU."""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as jget_tiny
from repro.core import HRMPolicy as JPolicy
from repro.core import MemoryDomain as JDomain
from repro.core import RetirementMap as JRetirementMap
from repro.core import Tier as JTier
from repro.core.errormodel import InjectionPlan as JPlan
from repro.core.policy import DESIGN_POINTS as JDESIGN_POINTS
from repro.models import init_params as jinit_params
from repro.models.transformer import init_cache as jinit_cache
from repro_torch.configs import get_tiny
from repro_torch.convert import (hard_errors_to_numpy, sidecar_to_numpy,
                                 state_from_numpy, state_to_numpy)
from repro_torch.core import (DESIGN_POINTS, HRMPolicy, InjectionPlan,
                              MemoryDomain, Response, RestartRequired,
                              RetirementMap, Tier)
from repro_torch.models import init_cache, init_params

POLICIES = ["typical_server", "detect_recover", "detect_recover_l",
            "mirror_dr_l", "dected_server", "burst_dr_l", "mixed",
            "mixed_strong"]
_MIXED = {
    "mixed": {"params/embed": "secded", "params/attn": "mirror",
              "params/mlp": "parity_r", "params/norm": "none",
              "kv_cache": "secded"},
    "mixed_strong": {"params/embed": "burst", "params/attn": "dected",
                     "params/mlp": "parity_r", "params/norm": "secded",
                     "kv_cache": "dected"},
}
# tiers that correct every single-bit strike in place
_CORRECTING = (Tier.SECDED, Tier.DECTED, Tier.BURST, Tier.MIRROR)


def _policies(name):
    """The (reference, port) pair of one named policy."""
    if name not in _MIXED:
        return JDESIGN_POINTS[name](), DESIGN_POINTS[name]()
    tiers = _MIXED[name]
    return (JPolicy(name, {r: JTier(t) for r, t in tiers.items()}),
            HRMPolicy(name, {r: Tier(t) for r, t in tiers.items()}))


@pytest.fixture(scope="module")
def jparams():
    return jinit_params(jax.random.PRNGKey(0), jget_tiny("llama3-8b"))


@pytest.fixture(scope="module")
def jstate(jparams):
    cfg = jget_tiny("llama3-8b")
    cache = jinit_cache(cfg, 2, 16)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    cache = {k: jax.random.normal(key, v.shape).astype(v.dtype)
             for key, (k, v) in zip(keys, sorted(cache.items()))}
    return {"params": jparams, "kv_cache": cache}


def _port_state(jtree):
    return state_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")


def _bytes(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _same_payload(jdom, tdom):
    jflat = jax.tree_util.tree_flatten_with_path(jdom.payload)[0]
    tleaves = [tdom.leaf(p) for p in tdom.paths()]
    assert len(jflat) == len(tleaves)
    tnp = state_to_numpy({str(i): t for i, t in enumerate(tleaves)})
    for i, (path, leaf) in enumerate(jflat):
        assert np.array_equal(_bytes(leaf), _bytes(tnp[str(i)])), path


def _same_sidecar(jdom, tdom):
    want = jax.tree.map(np.asarray, jdom.sidecar)
    got = sidecar_to_numpy(tdom.sidecar)
    assert set(want) == set(got)
    for tier in want:
        assert set(want[tier]) == set(got[tier]), tier
        for name in want[tier]:
            w = want[tier][name]
            g = got[tier][name]
            assert w.dtype == g.dtype and w.shape == g.shape, (tier, name)
            assert np.array_equal(w, g), (tier, name)


def _counts(d):
    return {k: int(np.asarray(v)) for k, v in d.items()}


def _same_report(jrep, trep):
    assert _counts(jrep.corrected) == _counts(trep.corrected)
    assert _counts(jrep.detected_uncorrectable) == \
        _counts(trep.detected_uncorrectable)
    assert jrep.totals() == trep.totals()
    assert jrep.needs_recovery() == trep.needs_recovery()


def _same_hard(jdom, tdom):
    want = {p: {k: np.asarray(v) for k, v in e.items()}
            for p, e in jdom.hard_errors.items()}
    got = hard_errors_to_numpy(tdom.hard_errors)
    assert set(want) == set(got)
    for p in want:
        for k in ("word", "bit"):
            assert np.array_equal(want[p][k], got[p][k]), (p, k)


def _same(jdom, tdom):
    _same_payload(jdom, tdom)
    _same_sidecar(jdom, tdom)
    _same_hard(jdom, tdom)


def _clean(dom):
    return {p: dom.leaf(p) for p in dom.paths()}


# ------------------------------------------------------------- layout
@pytest.mark.parametrize("name", POLICIES)
def test_protect_matches_reference(jparams, name):
    jpol, tpol = _policies(name)
    jdom = JDomain.protect(jparams, jpol)
    tdom = MemoryDomain.protect(_port_state(jparams), tpol)
    assert tdom.paths() == jdom.paths()
    assert tdom.paths()[:3] == ["blocks/attn/wk", "blocks/attn/wo",
                                "blocks/attn/wq"]
    for js, ts in zip(jdom.spec.leaves, tdom.spec.leaves):
        assert (ts.path, ts.pos, ts.region, ts.tier.value, ts.shape,
                ts.dtype, ts.rows, ts.row_start) == \
            (js.path, js.pos, js.region, js.tier.value, js.shape,
             js.dtype, js.rows, js.row_start)
        assert ts.nbytes == js.nbytes
    assert {t.value: g[0] for t, g in tdom.spec.groups.items()} == \
        {t.value: g[0] for t, g in jdom.spec.groups.items()}
    _same(jdom, tdom)
    js, ts = jdom.stats(), tdom.stats()
    assert (ts.payload_bytes, ts.sidecar_bytes, ts.n_leaves, ts.n_protected,
            ts.region_bytes, ts.region_tiers) == \
        (js.payload_bytes, js.sidecar_bytes, js.n_leaves, js.n_protected,
         js.region_bytes, js.region_tiers)
    assert dict(tdom.region_profile().fractions) == \
        dict(jdom.region_profile().fractions)


# -------------------------------------------------------- main path
@pytest.mark.parametrize("name", POLICIES)
def test_inject_scrub_recover_matches_reference(jstate, name):
    jpol, tpol = _policies(name)
    jdom = JDomain.protect(jstate, jpol)
    tdom = MemoryDomain.protect(_port_state(jstate), tpol)
    assert tdom.paths() == jdom.paths()
    _same(jdom, tdom)
    # multi-bit strikes too, so SEC-DED has uncorrectable words to report
    jbad, jev = jdom.inject(np.random.default_rng(11), 24,
                            multi_bit_fraction=0.25)
    tbad, tev = tdom.inject(np.random.default_rng(11), 24,
                            multi_bit_fraction=0.25)
    assert tev == jev
    _same(jbad, tbad)
    jfix, jrep = jbad.scrub()
    tfix, trep = tbad.scrub()
    _same(jfix, tfix)
    _same_report(jrep, trep)
    jclean, tclean = _clean(jdom), _clean(tdom)
    jrec, jrev = jfix.recover(jrep, clean_copy=jclean.__getitem__)
    trec, trev = tfix.recover(trep, clean_copy=tclean.__getitem__)
    assert trev == jrev
    _same(jrec, trec)


def _bytes_t(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("name", POLICIES)
def test_single_bit_strikes_are_restored(jstate, name):
    """Every single-bit strike on a protected leaf is corrected or reloaded;
    strikes on Tier NONE leaves stay, as the policy intends."""
    tdom = MemoryDomain.protect(_port_state(jstate), _policies(name)[1])
    bad, events = tdom.inject(np.random.default_rng(21), 32,
                              multi_bit_fraction=0.0)
    fixed, rep = bad.scrub()
    rec, _ = fixed.recover(rep, clean_copy=_clean(tdom).__getitem__)
    struck = {e["path"] for e in events}
    for s in rec.spec.leaves:
        same = torch.equal(_bytes_t(rec.leaf(s.path)),
                           _bytes_t(tdom.leaf(s.path)))
        if s.tier is not Tier.NONE:
            assert same, s.path
            if s.tier in _CORRECTING:
                assert int(rep.detected_uncorrectable[s.path]) == 0
        elif s.path not in struck:
            assert same, s.path


def test_quickstart_step_three(jparams):
    jdom = JDomain.protect(jparams, JDESIGN_POINTS["typical_server"]())
    tdom = MemoryDomain.protect(_port_state(jparams),
                                DESIGN_POINTS["typical_server"]())
    jbad, jev = jdom.inject(np.random.default_rng(7), 1)
    tbad, tev = tdom.inject(np.random.default_rng(7), 1)
    assert tev == jev
    jfix, jrep = jbad.scrub()
    tfix, trep = tbad.scrub()
    assert trep.totals() == jrep.totals() == (1, 0)
    _same(jfix, tfix)
    _same_payload(jdom, tfix)


def test_hard_error_drill_retires_the_same_blocks(jstate):
    jdom = JDomain.protect(jstate, JDESIGN_POINTS["detect_recover_l"]())
    tdom = MemoryDomain.protect(_port_state(jstate),
                                DESIGN_POINTS["detect_recover_l"]())
    par = [s.path for s in tdom.spec.leaves if s.tier is Tier.PARITY_R]
    jdom, jev = jdom.inject(np.random.default_rng(5), 3, hard=True,
                            paths=par, multi_bit_fraction=0.0)
    tdom, tev = tdom.inject(np.random.default_rng(5), 3, hard=True,
                            paths=par, multi_bit_fraction=0.0)
    assert tev == jev
    _same(jdom, tdom)
    jclean = _clean(JDomain.protect(jstate, JDESIGN_POINTS["typical_server"]()))
    tclean = {p: state_from_numpy({"x": np.asarray(v)}, device="cpu")["x"]
              for p, v in jclean.items()}
    jstrikes, tstrikes = {}, {}
    jret, tret = JRetirementMap(), RetirementMap()
    for _ in range(2):
        jfix, jrep = jdom.scrub()
        tfix, trep = tdom.scrub()
        _same_report(jrep, trep)
        assert trep.needs_recovery()
        jdom, jrev = jfix.recover(jrep, clean_copy=jclean.__getitem__,
                                  strikes=jstrikes, retirement=jret,
                                  retire_after=2)
        tdom, trev = tfix.recover(trep, clean_copy=tclean.__getitem__,
                                  strikes=tstrikes, retirement=tret,
                                  retire_after=2)
        assert trev == jrev and tstrikes == jstrikes
        jdom, tdom = jdom.reassert_hard(), tdom.reassert_hard()
        _same(jdom, tdom)
    assert tret.blocks == jret.blocks and tret.count() >= 1
    assert not tdom.hard_errors
    assert any("+retire" in e["action"] for e in trev)


def test_other_verbs_match_reference(jstate):
    jpol, tpol = _policies("mixed")
    jdom = JDomain.protect(jstate, jpol)
    tdom = MemoryDomain.protect(_port_state(jstate), tpol)
    path = "params/blocks/attn/wq"
    jplan = JPlan.sample(np.random.default_rng(2), 16 * 256, 4, True, 0.0)
    tplan = InjectionPlan.sample(np.random.default_rng(2), 16 * 256, 4, True,
                                 0.0)
    np.testing.assert_array_equal(tplan.word_idx, jplan.word_idx)
    jdom = jdom.apply_plan(path, jplan, record_hard=True)
    tdom = tdom.apply_plan(path, tplan, record_hard=True)
    _same(jdom, tdom)
    jfix, jrep = jdom.scrub(paths=[path, "params/embed", "kv_cache/k"])
    tfix, trep = tdom.scrub(paths=[path, "params/embed", "kv_cache/k"])
    _same(jfix, tfix)
    _same_report(jrep, trep)
    jfix, tfix = jfix.reassert_hard(), tfix.reassert_hard()
    _same(jfix, tfix)
    jfix, tfix = jfix.clear_hard(path), tfix.clear_hard(path)
    assert not tfix.hard_errors
    # a legitimate write, re-encoded for that leaf only, then in full
    new = np.asarray(jdom.leaf("params/embed")) * 2
    jw = jfix.with_leaf("params/embed", new).refresh(paths=["params/embed"])
    tw = tfix.with_leaf("params/embed", torch.from_numpy(new)).refresh(
        paths=["params/embed"])
    _same(jw, tw)
    _same(jw.refresh(), tw.refresh())
    # scrub on a schedule, and adopt of a structurally different state
    assert tw.scrub(step=1) == (tw, None)
    assert tw.scrub(step=0)[1] is not None
    with pytest.raises(ValueError):
        tw.adopt({"params": tw.root("params")})
    assert tw.adopt(tw.payload).payload is tw.payload


def test_recover_responses(jstate):
    tdom = MemoryDomain.protect(_port_state(jstate),
                                DESIGN_POINTS["detect_recover"]())
    bad, _ = tdom.inject(np.random.default_rng(1), 4,
                         paths=tdom.paths(protected_only=True))
    _, rep = bad.scrub()
    assert rep.needs_recovery()
    clean = _clean(tdom)
    with pytest.raises(RestartRequired):
        bad.recover(rep, clean_copy=clean.__getitem__,
                    response=Response.RESTART)
    same, ev = bad.recover(rep, clean_copy=clean.__getitem__,
                           response=Response.CONSUME)
    assert same is bad and ev[0]["action"] == "consume"
    peer, ev = bad.recover(rep, clean_copy=clean.__getitem__,
                           response=Response.PEER_COPY)
    assert [e["path"] for e in ev] == list(rep.needs_recovery())
    assert {e["action"] for e in ev} == {"peer_copy"}
    for e in ev:
        assert torch.equal(peer.leaf(e["path"]), clean[e["path"]])
        assert peer.leaf(e["path"]) is not clean[e["path"]]


def test_unsupported_leaves_and_tiers(jparams):
    jtree = {"w": jparams["final_norm"], "step": np.arange(3, dtype=np.int64)}
    jdom = JDomain.protect(jtree, JDESIGN_POINTS["typical_server"]())
    tdom = MemoryDomain.protect(
        {"w": _port_state({"w": jparams["final_norm"]})["w"],
         "step": torch.arange(3, dtype=torch.int64)},
        DESIGN_POINTS["typical_server"]())
    for js, ts in zip(jdom.spec.leaves, tdom.spec.leaves):
        assert (ts.path, ts.tier.value, ts.rows, ts.row_start, ts.dtype) == \
            (js.path, js.tier.value, js.rows, js.row_start, js.dtype)
    assert tdom.tier_of("step") is Tier.NONE and tdom.spec.by_path[
        "step"].rows == 0
    # every tier has its kernels: the strong-ECC design points protect too,
    # byte-identical to the reference, and leave the int64 leaf unprotected
    for name in ("dected_server", "burst_dr_l"):
        jdom = JDomain.protect(jtree, JDESIGN_POINTS[name]())
        tdom = MemoryDomain.protect(
            {"w": _port_state({"w": jparams["final_norm"]})["w"],
             "step": torch.arange(3, dtype=torch.int64)},
            DESIGN_POINTS[name]())
        assert tdom.tier_of("step") is Tier.NONE
        assert tdom.tier_of("w") is not Tier.NONE
        _same(jdom, tdom)


def test_port_model_state_has_the_reference_layout(jparams):
    tparams = init_params(get_tiny("llama3-8b"), seed=3, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tdom = MemoryDomain.protect(tparams, DESIGN_POINTS["consumer_pc"]())
    assert tdom.paths() == [jax.tree_util.keystr(p, simple=True,
                                                 separator="/")
                            for p, _ in jflat]
    for (_, jl), p in zip(jflat, tdom.paths()):
        t = tdom.leaf(p)
        assert tuple(t.shape) == jl.shape
        assert str(t.dtype).removeprefix("torch.") == str(jl.dtype)
    w = tdom.leaf("blocks/attn/wq").float()
    assert w.abs().max() <= 2.0 / 8.0 and w.std() > 0.05   # 2 / sqrt(64)
    again = init_params(get_tiny("llama3-8b"), seed=3, device="cpu")
    assert torch.equal(again["embed"], tparams["embed"])
    cfg = get_tiny("llama3-8b")
    jc = jinit_cache(jget_tiny("llama3-8b"), 2, 16)
    tc = init_cache(cfg, 2, 16, device="cpu")
    for k in ("k", "v"):
        assert tuple(tc[k].shape) == jc[k].shape
        assert str(tc[k].dtype).removeprefix("torch.") == str(jc[k].dtype)


def test_tree_order_and_paths_are_jax_order():
    from repro_torch.core import tree
    nested = {"z": {"b": 1, "a": {"y": 2, "x": 3}}, "c": 4,
              "a": {"k": 5}, "q": {}}
    flat, treedef = tree.flatten_with_path(nested)
    jflat, _ = jax.tree_util.tree_flatten_with_path(nested)
    assert [leaf for _, leaf in flat] == [leaf for _, leaf in jflat]
    assert ["/".join(p) for p, _ in flat] == [
        jax.tree_util.keystr(p, simple=True, separator="/")
        for p, _ in jflat]
    rebuilt = tree.unflatten(treedef, [leaf for _, leaf in flat])
    assert rebuilt == nested and list(rebuilt) == ["a", "c", "q", "z"]
    assert tree.structure(rebuilt) == treedef
    with pytest.raises(ValueError):
        tree.unflatten(treedef, [0] * 6)


@pytest.mark.parametrize("name", ["typical_server", "detect_recover",
                                  "dected_server", "burst_dr_l"])
def test_verbs_leave_no_reference_cycle(jstate, name):
    """Dropping the domains a main-path run made frees their struck and
    corrected leaves and sidecars at once: no reference cycle keeps them
    alive until the cycle collector runs (on the card that held gigabytes
    past their use)."""
    tdom = MemoryDomain.protect(_port_state(jstate), _policies(name)[1])
    clean = _clean(tdom)
    gc.collect()
    gc.disable()
    try:
        bad, _ = tdom.inject(np.random.default_rng(3), 16,
                             multi_bit_fraction=0.0)
        fixed, rep = bad.scrub()
        rec, _ = fixed.recover(rep, clean_copy=clean.__getitem__)
        def tensors(d):
            return d._leaves() + [t for bufs in d.sidecar.values()
                                  for t in bufs.values()]

        kept = {id(t) for t in tensors(tdom)}     # shared with the original
        refs = [weakref.ref(t) for d in (bad, fixed, rec)
                for t in tensors(d) if id(t) not in kept]
        assert refs
        del bad, fixed, rec, rep
        assert [r for r in refs if r() is not None] == []
    finally:
        gc.enable()


def test_scrub_report_totals_and_merge():
    from repro_torch.core import ScrubReport
    a = ScrubReport({"p": torch.tensor(2)}, {"p": torch.tensor(1),
                                             "q": torch.tensor(0)})
    b = ScrubReport({"p": 3}, {"q": 4})
    m = ScrubReport.merged([a, b])
    assert m.corrected == {"p": 5} and m.detected_uncorrectable == {
        "p": 1, "q": 4}
    assert a.totals() == (2, 1) and m.totals() == (5, 5)
    assert m.needs_recovery() == {"p": 1, "q": 4}
    assert ScrubReport().totals() == (0, 0)
    assert ScrubReport().needs_recovery() == {}

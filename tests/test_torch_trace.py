"""The port's error-trace engine against the JAX reference on the CPU: the
ten cases of ``tests/test_trace.py``, each held to the reference.

The generator gives the same arrays from the same config and seed; a
``.npz`` written by either package loads in the other; ``bind_trace``
resolves the same strikes on the same state (carried across through
numpy); the replayer's virtual clock fires the same events and leaves the
same payload and hard-error map; ``replay_availability`` and the explorer's
trace rows give the same numbers; ``run_trace_campaign`` classifies the
same outcomes, trial by trial, with the reference in Pallas interpret mode
as its own tests run it. Everything is compared exactly: the trace engine
is numpy, and the queries here are float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.characterize as jchar
import repro.launch.explore as jexplore
from repro.configs import get_tiny as jget_tiny
from repro.core import HRMPolicy as JPolicy
from repro.core import MemoryDomain as JDomain
from repro.core import Tier as JTier
from repro.core import availability as javail
from repro.core import trace as jtrace
from repro.core import tracegen as jtracegen
from repro.core.costmodel import WEBSEARCH as JWEBSEARCH
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro_torch.configs import get_tiny
from repro_torch.convert import (hard_errors_to_numpy, state_from_numpy,
                                 state_to_numpy)
from repro_torch.core import (WEBSEARCH, WEBSEARCH_VULN, HRMPolicy,
                              MemoryDomain, Tier, availability,
                              characterize, trace, tracegen)
from repro_torch.launch import explore
from repro_torch.models import forward

CPU = "cpu"
FIELDS = ("t", "dimm", "addr", "bit", "burst", "hard")


@pytest.fixture(scope="module")
def pair():
    """The same 80-event trace from both packages."""
    return (jtracegen.generate_error_trace(
                jtracegen.TraceGenConfig(n_events=80, n_dimms=4), seed=11),
            tracegen.generate_error_trace(
                tracegen.TraceGenConfig(n_events=80, n_dimms=4), seed=11))


def _jstate():
    return {"params": {
        "embed": jnp.arange(4096, dtype=jnp.float32).reshape(64, 64),
        "mlp": jnp.ones((64, 64), jnp.float32)}}


def _domains(jstate, jpolicy, policy):
    """(reference domain, port domain) over the same state."""
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), device=CPU)
    return (JDomain.protect(jstate, jpolicy),
            MemoryDomain.protect(tstate, policy))


def _same_arrays(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.dimm_bytes == b.dimm_bytes and a.duration == b.duration


def _bytes(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


# ---------------------------------------------------------- generation
def test_tracegen_field_shape(pair):
    want, got = pair
    _same_arrays(want, got)
    assert got.summary() == want.summary()
    assert got.meta == want.meta
    assert len(got) == 80 and np.all(np.diff(got.t) >= 0)
    assert got.months == pytest.approx(1.0)
    assert 0.2 <= got.hard.mean() <= 0.6
    phys = got.dimm.astype(np.int64) * got.dimm_bytes + got.addr
    assert len(np.unique(phys)) < len(got)        # repeat offenders exist
    assert len(np.unique(phys[got.hard])) <= 4 * 3


@pytest.mark.parametrize("seed", (5, 6))
def test_tracegen_deterministic(seed):
    cfg = tracegen.TraceGenConfig(n_events=40)
    a = tracegen.generate_error_trace(cfg, seed=seed)
    _same_arrays(a, tracegen.generate_error_trace(cfg, seed=seed))
    _same_arrays(a, jtracegen.generate_error_trace(
        jtracegen.TraceGenConfig(n_events=40), seed=seed))
    empty = tracegen.generate_error_trace(
        tracegen.TraceGenConfig(n_events=0), seed=seed)
    _same_arrays(empty, jtracegen.generate_error_trace(
        jtracegen.TraceGenConfig(n_events=0), seed=seed))


def test_trace_roundtrip(tmp_path, pair):
    """A file written by either package loads in the other."""
    want, got = pair
    for writer, reader, name in ((got, jtrace.ErrorTrace, "port.npz"),
                                 (want, trace.ErrorTrace, "ref.npz")):
        back = reader.load(writer.save(tmp_path / name))
        _same_arrays(writer, back)
        assert back.meta.get("generator") == writer.meta.get("generator")
    _same_arrays(trace.ErrorTrace.load(tmp_path / "port.npz"),
                 jtrace.ErrorTrace.load(tmp_path / "ref.npz"))


def test_tracegen_cli_writes_the_reference_file(tmp_path, capsys):
    args = ["--out", str(tmp_path / "m.npz"), "--events", "64", "--seed",
            "2"]
    assert tracegen.main(args) == 0
    got = capsys.readouterr().out
    jtracegen.main(["--out", str(tmp_path / "j.npz")] + args[2:])
    assert got.replace("m.npz", "j.npz") == capsys.readouterr().out
    _same_arrays(trace.ErrorTrace.load(tmp_path / "m.npz"),
                 jtrace.ErrorTrace.load(tmp_path / "j.npz"))


def test_trace_validation():
    ok = dict(t=np.array([0.0, 1.0]), dimm=np.zeros(2, np.int32),
              addr=np.zeros(2, np.int64), bit=np.array([0, 4], np.int8),
              burst=np.ones(2, np.int8), hard=np.zeros(2, bool))
    trace.ErrorTrace(**ok)
    for bad in ({"t": np.array([1.0, 0.0])},
                {"bit": np.array([0, 64], np.int8)},
                {"bit": np.array([62, 0], np.int8),
                 "burst": np.array([4, 1], np.int8)},
                {"burst": np.zeros(2, np.int8)},
                {"addr": np.zeros(3, np.int64)}):
        with pytest.raises(ValueError) as got:
            trace.ErrorTrace(**{**ok, **bad})
        with pytest.raises(ValueError) as want:
            jtrace.ErrorTrace(**{**ok, **bad})
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------- binding
@pytest.mark.parametrize("policy", ("none", "detect_recover"))
def test_bind_trace_equals_reference(pair, policy):
    """On the test state and on tiny llama3-8b's parameters: the same
    (domain, path, word, bits) for every event, repeat offenders on the
    same word, bursts as contiguous bit runs."""
    want_trace, got_trace = pair
    jp = jinit_params(jax.random.PRNGKey(0), jget_tiny("llama3-8b"))
    from repro.core.policy import DESIGN_POINTS as JDESIGN_POINTS
    from repro_torch.core import DESIGN_POINTS
    pols = ((JPolicy("t", {}, default=JTier.NONE),
             HRMPolicy("t", {}, default=Tier.NONE)) if policy == "none"
            else (JDESIGN_POINTS[policy](), DESIGN_POINTS[policy]()))
    j1, t1 = _domains(_jstate(), *pols)
    j2, t2 = _domains(jp, *pols)
    got = trace.bind_trace(got_trace, {"d": t1, "p": t2})
    assert got == jtrace.bind_trace(want_trace, {"d": j1, "p": j2})
    assert trace.bind_trace(got_trace, {"p": t2}, span=60.0) == \
        jtrace.bind_trace(want_trace, {"p": j2}, span=60.0)
    phys = got_trace.dimm.astype(np.int64) * got_trace.dimm_bytes \
        + got_trace.addr
    seen = {}
    for i, s in enumerate(got):
        assert seen.setdefault(int(phys[i]), (s.domain, s.path, s.word)) \
            == (s.domain, s.path, s.word)
        assert list(s.bits) == list(range(s.bits[0], s.bits[0]
                                          + int(got_trace.burst[i])))
        assert s.plan().word_idx.tolist() == \
            jtrace.BoundStrike(*s).plan().word_idx.tolist()


def test_replayer_virtual_clock(pair):
    """The same events fire by the same virtual times, and the replayed
    domains carry the same bytes and hard-error maps."""
    want_trace, got_trace = pair
    jdom, tdom = _domains(_jstate(), JPolicy("t", {}, default=JTier.NONE),
                          HRMPolicy("t", {}, default=Tier.NONE))
    jrep = jtrace.TraceReplayer(want_trace, jdom)
    rep = trace.TraceReplayer(got_trace, tdom)
    assert len(rep) == len(jrep) == len(got_trace)
    mid = float(np.median(got_trace.t))
    t2, fired = rep.play(tdom, until=mid)
    j2, jfired = jrep.play(jdom, until=mid)
    assert fired == jfired and 0 < len(fired) < len(got_trace)
    assert all(s.t <= mid for s in fired)
    assert rep.remaining == jrep.remaining == len(got_trace) - len(fired)
    assert rep.next_time() == jrep.next_time()
    t3, rest = rep.play(t2)
    j3, jrest = jrep.play(j2)
    assert rest == jrest and rep.next_time() is None
    jflat = jax.tree_util.tree_leaves(j3.payload)
    tnp = state_to_numpy({p: t3.leaf(p) for p in t3.paths()})
    for leaf, path in zip(jflat, t3.paths()):
        assert np.array_equal(_bytes(leaf), _bytes(tnp[path])), path
    clean = state_to_numpy({p: tdom.leaf(p) for p in tdom.paths()})
    assert any(not np.array_equal(_bytes(tnp[p]), _bytes(clean[p]))
               for p in tdom.paths())
    got_hard = hard_errors_to_numpy(t3.hard_errors)
    assert set(got_hard) == set(j3.hard_errors) \
        == {s.path for s in fired + rest if s.hard}
    for p, err in j3.hard_errors.items():
        for k in ("word", "bit"):
            assert np.array_equal(np.asarray(err[k]), got_hard[p][k])
    rep.reset()
    assert rep.remaining == len(got_trace)


# -------------------------------------------------------- availability
def _avail(a):
    return (a.name, a.crashes_per_month, a.recoveries_per_month,
            a.incorrect_per_million, a.downtime_min_per_month,
            a.availability, a.peer_recoveries_per_month)


@pytest.mark.parametrize("seed", (0, 7))
def test_replay_availability_equals_reference(pair, seed):
    want_trace, got_trace = pair
    np.testing.assert_array_equal(
        availability._event_unit(got_trace, seed),
        javail._event_unit(want_trace, seed))
    tiers = {"private": "secded", "heap": "parity_r", "stack": "parity_r",
             "other": "none"}
    for kw in ({}, {"software_response": False}, {"peer_recovery": True}):
        got = availability.replay_availability(
            "x", {r: Tier(t) for r, t in tiers.items()}, WEBSEARCH,
            WEBSEARCH_VULN, got_trace, seed=seed, **kw)
        want = javail.replay_availability(
            "x", {r: JTier(t) for r, t in tiers.items()}, JWEBSEARCH,
            javail.WEBSEARCH_VULN, want_trace, seed=seed, **kw)
        assert _avail(got) == _avail(want)
    none = availability.replay_availability(
        "none", {r: Tier.NONE for r in WEBSEARCH.fractions}, WEBSEARCH,
        WEBSEARCH_VULN, got_trace, seed=seed)
    assert got.availability >= none.availability


def test_replay_availability_burst_rules(pair):
    """Each tier's rule for each burst width is the reference's; under
    DEC-TED with a software response nothing of width <= 3 is consumed."""
    want_trace, got_trace = pair
    for tier in Tier:
        for width in range(1, 5):
            assert availability._burst_outcome(tier, width) == \
                javail._burst_outcome(JTier(tier.value), width)
        got = availability.replay_availability(
            tier.value, {r: tier for r in WEBSEARCH.fractions}, WEBSEARCH,
            WEBSEARCH_VULN, got_trace)
        want = javail.replay_availability(
            tier.value, {r: JTier(tier.value) for r in JWEBSEARCH.fractions},
            JWEBSEARCH, javail.WEBSEARCH_VULN, want_trace)
        assert _avail(got) == _avail(want)
    if int(got_trace.burst.max()) <= 3:
        dt = availability.replay_availability(
            "dt", {r: Tier.DECTED for r in WEBSEARCH.fractions}, WEBSEARCH,
            WEBSEARCH_VULN, got_trace)
        assert dt.incorrect_per_million == 0.0


def _row(r):
    return tuple(vars(r).values())


def test_explore_trace_rows(pair):
    """Every workload's trace rows, measured ECC rates and the auto-tuned
    point included, equal the reference's; costs equal the analytic
    table's."""
    want_trace, got_trace = pair
    designs = list(explore.DESIGNS)
    for name in explore.WORKLOADS:
        kw = {"device": CPU} if name != "websearch" else {}
        w = explore.build_workload(name, **kw)
        jw = jexplore.build_workload(name)
        got = explore.explore_workload_trace(w, designs, got_trace,
                                             device=CPU)
        want = jexplore.explore_workload_trace(jw, designs, want_trace)
        assert [_row(r) for r in got] == [_row(r) for r in want]
        assert all(r.ecc_source == "trace" for r in got)
        analytic = explore.explore_workload(w, designs, device=CPU)
        assert [r.memory_cost_rel for r in got] == \
            [r.memory_cost_rel for r in analytic]
        again = explore.explore_workload_trace(w, designs[:2], got_trace,
                                               seed=3, device=CPU)
        assert [_row(r) for r in again] == [_row(r) for r in (
            jexplore.explore_workload_trace(jw, designs[:2], want_trace,
                                            seed=3))]


# ------------------------------------------------------------ campaign
def _ref_trace_trials(ev, state, trace_, **kw):
    """The reference's trace campaign, each trial's (path, hard, outcome)
    recorded in order."""
    rec = []
    run_trial = jchar._run_trial

    def record(domain, s, plan, *a, **k):
        out = run_trial(domain, s, plan, *a, **k)
        rec.append((s.path, "hard" if a[-2] else "soft", out.value))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jchar, "_run_trial", record)
        res = jchar.run_trace_campaign(ev, state, trace_, **kw)
    return res, rec


def _stats(res):
    return {k: {o.value: n for o, n in v.counts.items()}
            for k, v in res.stats.items()}


def test_trace_campaign_equals_reference():
    """The test file's guarded-sum query on a 2048-word leaf, twice (the
    same outcomes every run), and capped at five events."""
    want_trace = jtracegen.generate_error_trace(
        jtracegen.TraceGenConfig(n_events=12, n_dimms=2), seed=3)
    got_trace = tracegen.generate_error_trace(
        tracegen.TraceGenConfig(n_events=12, n_dimms=2), seed=3)
    jstate = {"w": jnp.arange(2048, dtype=jnp.float32)}
    tstate = {"w": torch.arange(2048, dtype=torch.float32)}

    def jev(s):
        ok = jnp.isfinite(s["w"]).all() & (jnp.abs(s["w"]).max() < 1e12)
        return jnp.where(ok, jnp.ones(3, jnp.int32), -1), s

    def ev(s):
        ok = torch.isfinite(s["w"]).all() & (s["w"].abs().max() < 1e12)
        return torch.where(ok, torch.ones(3, dtype=torch.int64), -1), s

    want, rec = _ref_trace_trials(jev, jstate, want_trace)
    r1 = characterize.run_trace_campaign(ev, tstate, got_trace)
    r2 = characterize.run_trace_campaign(ev, tstate, got_trace)
    assert [(p, k, o.value) for p, k, o in r1.trials] == rec
    assert r1.trials == r2.trials and _stats(r1) == _stats(want)
    assert len(r1.trials) == len(got_trace)
    capped = characterize.run_trace_campaign(ev, tstate, got_trace,
                                             max_events=5)
    assert capped.trials == r1.trials[:5]


def test_trace_campaign_on_kvstore_equals_reference():
    """Tiny kvstore-demo (float32 compute) queried by the explorer's keys,
    the reference's parameters and keys carried across: outcomes equal
    trial by trial, region filter included."""
    jcfg = jget_tiny("kvstore-demo").replace(compute_dtype="float32")
    cfg = get_tiny("kvstore-demo").replace(compute_dtype="float32")
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    keys = jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0,
                              jcfg.vocab_size)
    tp = state_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    tkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
    want_trace = jtracegen.generate_error_trace(
        jtracegen.TraceGenConfig(n_events=40), seed=4)
    got_trace = tracegen.generate_error_trace(
        tracegen.TraceGenConfig(n_events=40), seed=4)
    jev = jchar.lm_eval_fn(jcfg, {"tokens": keys}, jforward)
    ev = characterize.lm_eval_fn(cfg, {"tokens": tkeys}, forward)
    for region_filter in (None, lambda r: r != "params/embed"):
        want, rec = _ref_trace_trials(jev, jp, want_trace,
                                      region_filter=region_filter)
        got = characterize.run_trace_campaign(ev, tp, got_trace,
                                              region_filter=region_filter)
        assert [(p, k, o.value) for p, k, o in got.trials] == rec
        assert _stats(got) == _stats(want)
    assert len(rec) < len(got_trace)      # the filter dropped events

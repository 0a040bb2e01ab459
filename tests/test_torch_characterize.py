"""The port's Fig. 2 campaign against the JAX reference on the CPU.

Both packages draw the same ``(path, plan)`` sequence from the same seed,
compared exactly, and classify each trial alike, compared trial by trial,
on the three applications of ``examples/characterize.py``: tiny llama3-8b
(float32 compute; 8 soft and 4 hard trials), tiny kvstore-demo (its own
bfloat16 compute; 30 + 30) and PageRank on the 256-node power-law graph
(20 + 20). The reference's parameters and keys are carried across through
numpy; the reference runs as its own tests run it (jitted queries, Pallas
in interpret mode).

A trial may be set aside only when the two packages disagree and some
position's top-2 margin in the reference's corrupted run is below 10x the
largest output difference the two packages show on the golden run (the
graph: the gap between neighbouring top-(k+1) ranks against the largest
rank difference). The test prints the count and fails above 10 % set
aside.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.characterize as jchar
from repro import graph as jgraph
from repro.configs import get_tiny as jget_tiny
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core import HRMPolicy as JPolicy
from repro.core import MemoryDomain as JDomain
from repro.core.errormodel import InjectionPlan as JPlan
from repro.core.taxonomy import Outcome as JOutcome
from repro.core.taxonomy import OutcomeStats as JStats
from repro.data.synthetic import make_batch as jmake_batch
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro_torch import graph as tgraph
from repro_torch.configs import get_tiny
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import state_from_numpy
from repro_torch.core import (HRMPolicy, InjectionPlan, MemoryDomain,
                              Outcome, OutcomeStats, characterize)
from repro_torch.data.synthetic import make_batch
from repro_torch.kernels._build import KernelError
from repro_torch.models import forward

CPU = "cpu"
SET_ASIDE_MARGIN = 10.0
SET_ASIDE_SHARE = 0.10


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_trials(ev, state, **kw):
    """Run the reference's campaign, recording each trial's (path, plan,
    outcome) in order."""
    rec = []
    run_trial = jchar._run_trial

    def record(domain, s, plan, *a, **k):
        out = run_trial(domain, s, plan, *a, **k)
        rec.append((s.path, plan, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jchar, "_run_trial", record)
        jchar.run_campaign(ev, state, **kw)
    return rec


# ---------------------------------------------------------- applications
def _lm_app():
    """Tiny llama3-8b, float32 compute, the example's batch."""
    jcfg = jget_tiny("llama3-8b").replace(compute_dtype="float32")
    cfg = get_tiny("llama3-8b").replace(compute_dtype="float32")
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    jb = jmake_batch(jcfg, JShapeSpec("c", 32, 2, "train"))
    b = make_batch(cfg, ShapeSpec("c", 32, 2, "train"), device=CPU)
    return jcfg, cfg, jp, jb, b


def _kv_app():
    """Tiny kvstore-demo (bfloat16 compute), the example's params and
    keys."""
    jcfg, cfg = jget_tiny("kvstore-demo"), get_tiny("kvstore-demo")
    jp = jinit_params(jax.random.PRNGKey(1), jcfg)
    keys = jax.random.randint(jax.random.PRNGKey(2), (2, 32), 0,
                              jcfg.vocab_size)
    b = {"tokens": torch.from_numpy(np.array(keys)).long()}
    return jcfg, cfg, jp, {"tokens": keys}, b


def _lm_logits(jcfg, jb):
    return jax.jit(lambda p: jforward(p, jb, jcfg)[0].astype(jnp.float32))


def _lm_campaigns(app, runs):
    """Reference and port trials of an LM application over ``runs`` =
    ((kinds, n_trials, seed), ...), plus its set-aside margin."""
    jcfg, cfg, jp, jb, b = app
    logits = _lm_logits(jcfg, jb)
    jev = jax.jit(lambda p: jchar.lm_eval_fn(jcfg, jb, jforward)(p)[0])
    p = state_from_numpy(_np(jp), device=CPU)
    ev = characterize.lm_eval_fn(cfg, b, forward)
    ref, port, strikes = [], [], []
    for kinds, n, seed in runs:
        kw = dict(n_trials=n, seed=seed, kinds=kinds)
        ref += _ref_trials(lambda q: (jev(q), q), jp, **kw)
        port += characterize.run_campaign(ev, p, **kw).trials
        dom = characterize._campaign_domain(p, "params")[0]
        strikes += list(characterize._campaign_strikes(
            dom, errors_per_trial=1, region_filter=None, **kw))
    golden_diff = float(np.abs(
        np.asarray(logits(jp)) - forward(p, b, cfg)[0].float().numpy()
    ).max())
    jdom = JDomain.protect(jp, JPolicy("campaign/params", {}))

    def margin(path, plan):
        z = np.sort(np.asarray(logits(jdom.apply_plan(path, plan).payload)),
                    axis=-1)
        return float(np.nan_to_num(z[..., -1] - z[..., -2]).min())
    return ref, port, strikes, margin, golden_diff


def _graph_campaigns():
    """PageRank top-8 on the example's 256-node graph, 20 + 20 trials."""
    jg = jgraph.powerlaw_graph(256, avg_degree=8, seed=5)
    g = tgraph.powerlaw_graph(256, avg_degree=8, seed=5)
    jdom = JDomain.protect({"graph": jgraph.graph_state(jg)},
                           JPolicy("campaign/graph", {}))
    dom = MemoryDomain.protect({"graph": tgraph.graph_state(g, device=CPU)},
                               HRMPolicy("campaign/graph", {}))
    kw = dict(n_trials=20, seed=6)
    ref = _ref_trials(jgraph.pagerank_eval_fn(jg.n, iters=12), jdom, **kw)
    port = characterize.run_campaign(
        tgraph.pagerank_eval_fn(g.n, iters=12), dom, **kw).trials
    strikes = list(characterize._campaign_strikes(
        dom, errors_per_trial=1, region_filter=None,
        kinds=("soft", "hard"), **kw))

    def ranks(payload, pagerank):
        return np.asarray(pagerank(payload["graph"], jg.n, iters=12)[1])

    golden_diff = float(np.abs(
        ranks(jdom.payload, jgraph.pagerank)
        - ranks(dom.payload, tgraph.pagerank)).max())

    def margin(path, plan):
        r = np.sort(ranks(jdom.apply_plan(path, plan).payload,
                          jgraph.pagerank)[0, :jg.n])[::-1][:9]
        return float(np.nan_to_num(-np.diff(r)).min())
    return ref, port, strikes, margin, golden_diff


@pytest.fixture(scope="module")
def campaigns():
    return {
        "llama3-8b": _lm_campaigns(_lm_app(), ((("soft",), 8, 3),
                                               (("hard",), 4, 3))),
        "kvstore-demo": _lm_campaigns(_kv_app(), ((("soft", "hard"), 30,
                                                   4),)),
        "graph": _graph_campaigns(),
    }


APPS = ("llama3-8b", "kvstore-demo", "graph")


@pytest.mark.parametrize("app", APPS)
def test_strike_sequence_equal_reference(campaigns, app):
    ref, port, strikes, _, _ = campaigns[app]
    assert len(strikes) == len(ref) == len(port)
    for (path, jplan, _), (kind, s, plan), (tpath, tkind, _) in zip(
            ref, strikes, port):
        assert s.path == tpath == path
        assert tkind == kind and plan.hard == jplan.hard == (kind == "hard")
        np.testing.assert_array_equal(plan.word_idx, jplan.word_idx)
        np.testing.assert_array_equal(plan.bit_idx, jplan.bit_idx)


@pytest.mark.parametrize("app", APPS)
def test_outcomes_equal_reference_trial_by_trial(campaigns, app):
    ref, port, _, margin, golden_diff = campaigns[app]
    set_aside = 0
    for (path, plan, want), (_, kind, got) in zip(ref, port):
        if got.value == want.value:
            continue
        m = margin(path, plan)
        assert m < SET_ASIDE_MARGIN * golden_diff, \
            f"{kind} strike on {path}: port {got}, reference {want}, " \
            f"margin {m} against golden difference {golden_diff}"
        set_aside += 1
    print(f"{app}: {set_aside} of {len(ref)} trials set aside "
          f"(golden difference {golden_diff:.3g})")
    assert set_aside <= SET_ASIDE_SHARE * len(ref)
    # the comparison covers more than one class of outcome
    assert len({o for _, _, o in port}) >= 2


def test_taxonomy_equals_reference():
    assert [o.value for o in Outcome] == [o.value for o in JOutcome]
    counts = (3, 1, 4, 2)
    got, want = OutcomeStats.zero(), JStats.zero()
    for o, jo, n in zip(Outcome, JOutcome, counts):
        got.add(o, n)
        want.add(jo, n)
    for name in ("total", "crash_prob", "incorrect_prob", "tolerance",
                 "vulnerability"):
        assert getattr(got, name) == getattr(want, name), name


def test_campaign_result_pools_like_reference():
    got, want = characterize.CampaignResult(), jchar.CampaignResult()
    cells = (("params/attn", "soft", 0, 3), ("params/attn", "hard", 3, 1),
             ("params/mlp", "soft", 2, 5), ("params/embed", "hard", 1, 2))
    for region, kind, o, n in cells:
        got.stat(region, kind).add(list(Outcome)[o], n)
        want.stat(region, kind).add(list(JOutcome)[o], n)
    assert got.regions() == want.regions()
    for region in (None, "params/attn", "params/mlp"):
        for kind in (None, "soft", "hard"):
            assert got.crash_prob(region, kind) == \
                want.crash_prob(region, kind)
            assert got.incorrect_prob(region, kind) == \
                want.incorrect_prob(region, kind)


def test_classify_trial_equals_reference():
    """Leaves compare by value, as ``np.array_equal`` does: -0.0 equals
    0.0 and NaN equals nothing."""
    golden = np.array([3, 1, 4], np.int64)
    clean = np.array([0.0, 1.5, 2.0], np.float32)
    cases = [
        (golden, clean, False),
        (golden, np.array([-0.0, 1.5, 2.0], np.float32), False),
        (golden, np.array([0.0, np.nan, 2.0], np.float32), False),
        (golden, np.array([0.0, 1.5, 2.5], np.float32), False),
        (np.array([3, 1, 5]), clean, False),
        (np.array([3, 1]), clean, False),
        (golden, clean, True),
    ]
    for out, final, crashed in cases:
        want = jchar.classify_trial(golden, out, clean, final, crashed)
        got = characterize.classify_trial(
            torch.from_numpy(golden), torch.from_numpy(out),
            torch.from_numpy(clean), torch.from_numpy(final), crashed)
        assert got.value == want.value, (out, final, crashed)


def _toy():
    """A read-only state of one float32 leaf whose query answers the signs
    of its values: a sign flip is incorrect, a low mantissa flip masked."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal(600).astype(np.float32)

    def ev(p):
        return (p["w"] > 0).to(torch.int64), p

    def jev(p):
        return (p["w"] > 0).astype(jnp.int32), p
    return w, ev, jev


def _toy_trial(w, ev, plan):
    p = {"w": torch.from_numpy(w)}
    dom, wrapped, unwrap = characterize._campaign_domain(p, "params")
    golden = ev(p)[0]
    return characterize._run_trial(dom, dom.spec.by_path["w"], plan, ev,
                                   golden, unwrap, wrapped, "params",
                                   plan.hard, 3)


def test_a_bit_flipped_twice_is_masked():
    w, ev, _ = _toy()
    twice = InjectionPlan(np.array([5, 5, -1, -1], np.int32),
                          np.array([63, 63, 0, 0], np.int32), False)
    assert _toy_trial(w, ev, twice) is Outcome.MASKED_OVERWRITE
    once = InjectionPlan(np.array([5, -1], np.int32),
                         np.array([31, 0], np.int32), False)   # a sign bit
    assert _toy_trial(w, ev, once) is Outcome.INCORRECT


def test_hard_trial_reapplies_the_plan_after_each_query():
    """The reference's protocol: ``hard_repeat`` queries, the plan re-applied
    to the state each query left. On a read-only state the second query
    therefore sees the flip undone; both packages see the same sequence."""
    w, ev, jev = _toy()
    seen, jseen = [], []

    def spy(p):
        seen.append(bool(torch.equal(p["w"], torch.from_numpy(w))))
        return ev(p)

    def jspy(p):
        jseen.append(bool(np.array_equal(np.asarray(p["w"]), w)))
        return jev(p)
    plan = InjectionPlan(np.array([7, -1], np.int32),
                         np.array([31, 0], np.int32), True)
    assert _toy_trial(w, spy, plan) is Outcome.INCORRECT
    jp = {"w": jnp.asarray(w)}
    jdom, jwrapped, junwrap = jchar._campaign_domain(jp, "params")
    jgolden = np.asarray(jev(jp)[0])
    jspy(jp)
    jout = jchar._run_trial(jdom, jdom.spec.by_path["w"],
                            JPlan(plan.word_idx, plan.bit_idx, True), jspy,
                            jgolden, junwrap, jwrapped, "params", True, 3)
    assert jout.value == Outcome.INCORRECT.value
    # golden, then the three queries: struck, un-flipped, struck again
    assert seen == jseen == [True, False, True, False]


def test_wrapped_root_overwrite_equals_reference():
    """A mutable root (``root="kv_cache"``): the query overwrites the
    state, so flips it does not read classify as MASKED_OVERWRITE."""
    rng = np.random.default_rng(2)
    k = rng.standard_normal((16, 64)).astype(np.float32)

    def ev(c):
        return (c["k"][:, :8] > 0).to(torch.int64).reshape(-1), \
            {"k": torch.from_numpy(k)}

    def jev(c):
        return (c["k"][:, :8] > 0).astype(jnp.int32).reshape(-1), \
            {"k": jnp.asarray(k)}
    kw = dict(n_trials=24, seed=9, root="kv_cache")
    ref = _ref_trials(jev, {"k": jnp.asarray(k)}, **kw)
    port = characterize.run_campaign(ev, {"k": torch.from_numpy(k)},
                                     **kw).trials
    assert [(p, o.value) for p, _, o in ref] == \
        [(p, o.value) for p, _, o in port]
    assert {o for _, _, o in port} >= {Outcome.MASKED_OVERWRITE}


@pytest.mark.parametrize("fault", [
    KernelError("bitflip kernel launch failed: CUDA error 700"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling cublasGemmEx"),
    torch.OutOfMemoryError("out of memory"),
])
def test_program_faults_propagate(fault):
    """Errors of the kernels, the CUDA runtime and the device are never a
    CRASH outcome: they end the campaign."""
    w, ev, _ = _toy()

    def broken(p):
        raise fault
    plan = InjectionPlan(np.array([1, -1], np.int32),
                         np.array([3, 0], np.int32), False)
    with pytest.raises(type(fault)):
        _toy_trial(w, broken, plan)


@pytest.mark.parametrize("reply", ["raise_value", "raise_runtime",
                                   "negative", "nan"])
def test_query_failures_are_crashes(reply):
    w, ev, _ = _toy()

    def query(p):
        if reply == "raise_value":
            raise ValueError("corrupted index")
        if reply == "raise_runtime":
            raise RuntimeError("the query diverged")
        if reply == "negative":
            return torch.full((3,), -1), p
        return torch.tensor([0.0, float("nan")]), p
    plan = InjectionPlan(np.array([1, -1], np.int32),
                         np.array([3, 0], np.int32), False)
    p = {"w": torch.from_numpy(w)}
    dom, wrapped, unwrap = characterize._campaign_domain(p, "params")
    out = characterize._run_trial(dom, dom.spec.by_path["w"], plan, query,
                                  torch.zeros(3, dtype=torch.int64), unwrap,
                                  wrapped, "params", False, 3)
    assert out is Outcome.CRASH


def test_lm_eval_fn_marks_non_finite_logits():
    logits = torch.zeros(2, 3, 5, dtype=torch.bfloat16)
    logits[..., 2] = 1

    def fwd(p, batch, cfg):
        return p, None, None
    ev = characterize.lm_eval_fn(None, None, fwd)
    toks, _ = ev(logits)
    assert toks.tolist() == [[2, 2, 2], [2, 2, 2]]
    logits[1, 0, 4] = float("inf")
    assert (ev(logits)[0] == -1).all()

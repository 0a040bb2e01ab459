"""The port's policy auto-tuner and Fig. 5 explorer against the JAX
reference on the CPU: ``tune_policy`` results, ``vuln_from_campaign``
profiles and the explorer's rows equal as floats (websearch, calibrated
kvstore, calibrated graph at 512 nodes, dense and node-blocked), the
``--dry-run`` text equal character for character, and the measured
(``--measure``) vulnerability profiles equal when the reference's kv-store
parameters and keys are carried across (the graph is the same from the
same seed in both packages)."""
import jax
import numpy as np
import pytest

from repro.configs import get_tiny as jget_tiny
from repro.core import autopolicy as jauto
from repro.core import characterize as jchar
from repro.core.availability import WEBSEARCH_VULN as JWEBSEARCH_VULN
from repro.core.availability import VulnProfile as JVulnProfile
from repro.core.costmodel import WEBSEARCH as JWEBSEARCH
from repro.core.policy import HRMPolicy as JPolicy
from repro.core.domain import MemoryDomain as JDomain
from repro.core.taxonomy import Outcome as JOutcome
from repro.launch import explore as jexplore
from repro.models import init_params as jinit_params
from repro_torch.convert import state_from_numpy
from repro_torch.core import (WEBSEARCH, WEBSEARCH_VULN, HRMPolicy,
                              MemoryDomain, Outcome, VulnProfile,
                              characterize, tune_policy,
                              tune_policy_for_domain, vuln_from_campaign)
from repro_torch.launch import explore

CPU = "cpu"


def _result(r):
    """An AutoPolicyResult as plain values."""
    return ({k: t.value for k, t in r.policy.tiers.items()},
            r.policy.default.value, r.policy.error_model.less_tested,
            r.memory_cost_rel, r.memory_saving, r.availability,
            r.crashes_per_month, r.incorrect_per_million)


def _vuln(v):
    return (v.p_crash, v.r_incorrect)


@pytest.mark.parametrize("avail,bad,less", [
    (0.9990, 9.5, False), (0.9990, 12.0, True), (0.99, 1000.0, False),
    (0.9999, 1.0, False), (1.0, 0.0, False), (0.9995, 4.0, True)])
def test_tune_policy_equals_reference(avail, bad, less):
    kw = dict(availability_target=avail, incorrect_target_per_million=bad,
              less_tested=less)
    want = jauto.tune_policy(JWEBSEARCH, JWEBSEARCH_VULN, **kw)
    got = tune_policy(WEBSEARCH, WEBSEARCH_VULN, **kw)
    assert _result(got) == _result(want)
    assert got.summary() == want.summary()


def test_tune_policy_infeasible_raises_as_reference():
    kw = dict(availability_target=1.0, incorrect_target_per_million=-1.0)
    with pytest.raises(ValueError):
        jauto.tune_policy(JWEBSEARCH, JWEBSEARCH_VULN, **kw)
    with pytest.raises(ValueError, match="all-DEC-TED"):
        tune_policy(WEBSEARCH, WEBSEARCH_VULN, **kw)


def _campaign_pair():
    got, want = characterize.CampaignResult(), jchar.CampaignResult()
    cells = (("params/attn", "soft", (5, 2, 1, 0)),
             ("params/attn", "hard", (1, 1, 2, 1)),
             ("params/embed", "soft", (9, 3, 1, 0)),
             ("params/mlp", "hard", (2, 4, 0, 2)))
    for region, kind, counts in cells:
        for o, jo, n in zip(Outcome, JOutcome, counts):
            got.stat(region, kind).add(o, n)
            want.stat(region, kind).add(jo, n)
    return got, want


def test_vuln_from_campaign_equals_reference():
    got, want = _campaign_pair()
    assert _vuln(vuln_from_campaign(got)) == \
        _vuln(jauto.vuln_from_campaign(want))
    assert _vuln(vuln_from_campaign(got, incorrect_scale=1.5)) == \
        _vuln(jauto.vuln_from_campaign(want, incorrect_scale=1.5))


def test_tune_policy_for_domain_equals_reference():
    """The region profile measured from a live domain over the reference's
    tiny llama3-8b parameters, and a campaign result as the vulnerability."""
    jp = jinit_params(jax.random.PRNGKey(0), jget_tiny("llama3-8b"))
    p = state_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    jdom = JDomain.protect(jp, JPolicy("none", {}))
    dom = MemoryDomain.protect(p, HRMPolicy("none", {}))
    got, want = _campaign_pair()
    kw = dict(availability_target=0.9990, incorrect_target_per_million=12.0)
    assert _result(tune_policy_for_domain(dom, got, **kw)) == \
        _result(jauto.tune_policy_for_domain(jdom, want, **kw))
    assert _vuln(VulnProfile({"params/mlp": 0.5}, {})) == \
        _vuln(JVulnProfile({"params/mlp": 0.5}, {}))


def _rows(w, designs=explore.DESIGNS):
    return [vars(r) for r in explore.explore_workload(w, list(designs),
                                                      device=CPU)]


def _jrows(w, designs=jexplore.DESIGNS):
    return [vars(r) for r in jexplore.explore_workload(w, list(designs))]


@pytest.mark.parametrize("name,kw", [
    ("websearch", {}),
    ("kvstore", {}),
    ("graph", {"n_nodes": 512}),
    ("graph", {"n_nodes": 512, "node_block": 128}),
])
def test_explore_rows_equal_reference(name, kw):
    dev = {} if name == "websearch" else {"device": CPU}
    got = explore.build_workload(name, **kw, **dev)
    want = jexplore.build_workload(name, **kw)
    assert got.profile.fractions == want.profile.fractions
    assert _vuln(got.vuln) == _vuln(want.vuln)
    assert (got.vuln_source, got.paper) == (want.vuln_source, want.paper)
    assert _rows(got) == _jrows(want)
    assert explore.format_table(got, explore.explore_workload(
        got, list(explore.DESIGNS), device=CPU)) == jexplore.format_table(
        want, jexplore.explore_workload(want, list(jexplore.DESIGNS)))


def test_dry_run_text_equals_reference(capsys):
    argv = ["--workload", "all", "--design", "all", "--dry-run"]
    assert jexplore.main(argv) == 0
    want = capsys.readouterr().out
    assert explore.main(argv + ["--device", CPU]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert got.rstrip().endswith("EXPLORE DRY-RUN OK")


def test_measured_kvstore_vuln_equals_reference(monkeypatch):
    """``--measure`` on the kv-store with the reference's parameters and
    keys carried across: the same campaign outcomes, so the same profile
    and the same rows."""
    cfg = jget_tiny("kvstore-demo")
    jp = jinit_params(jax.random.PRNGKey(0), cfg)
    keys = jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0,
                              cfg.vocab_size)

    def reference_state(cfg, seed, device):
        carried = state_from_numpy(
            {"params": jax.tree.map(np.asarray, jp),
             "keys": np.asarray(keys).astype(np.int64)}, device=device)
        return carried["params"], carried["keys"]

    monkeypatch.setattr(explore, "_kvstore_state", reference_state)
    want = jexplore.kvstore_workload(measure=True, trials=20)
    got = explore.kvstore_workload(measure=True, trials=20, device=CPU)
    assert got.vuln_source == want.vuln_source == "measured (20 trials)"
    assert _vuln(got.vuln) == _vuln(want.vuln)
    assert got.profile.fractions == want.profile.fractions
    assert _rows(got) == _jrows(want)


def test_measured_graph_vuln_equals_reference():
    """``--measure`` on the 512-node graph: PageRank and BFS queries."""
    want = jexplore.graph_workload(measure=True, trials=20)
    got = explore.graph_workload(measure=True, trials=20, device=CPU)
    assert got.vuln_source == want.vuln_source
    assert _vuln(got.vuln) == _vuln(want.vuln)
    assert _rows(got) == _jrows(want)


def test_kvstore_state_is_seeded():
    """Without the reference's state the port draws its own, from a seeded
    generator: the same seed, the same parameters and keys."""
    cfg = explore.get_tiny("kvstore-demo")
    (p1, k1), (p2, k2) = (explore._kvstore_state(cfg, 3, CPU)
                          for _ in range(2))
    assert k1.shape == (2, 32) and bool((k1 == k2).all())
    assert bool((p1["embed"] == p2["embed"]).all())
    assert int(k1.max()) < cfg.vocab_size


def test_trace_waits_for_the_trace_engine(tmp_path, capsys):
    """The trace engine is ported: ``--trace`` prints the reference's
    analytic and trace-driven tables for a trace file written by the
    port."""
    from repro_torch.core import TraceGenConfig, generate_error_trace
    path = generate_error_trace(TraceGenConfig(n_events=60),
                                seed=2).save(tmp_path / "m.npz")
    argv = ["--workload", "all", "--dry-run", "--trace", str(path),
            "--trace-seed", "1"]
    assert jexplore.main(argv) == 0
    want = capsys.readouterr().out
    assert explore.main(argv + ["--device", CPU]) == 0
    got = capsys.readouterr().out
    assert got == want and got.count("ecc_src=trace") == 3

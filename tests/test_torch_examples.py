"""The port's example entry points (``repro_torch.examples``) on the CPU:
each ``main([..., "--device", "cpu"])`` ends with its reference script's
``... OK`` line, and where it is cheap the numbers it prints equal what
the reference's same API calls print on the same parameters (the port's
own, carried across through numpy): quickstart's struck path, scrub
totals, Par+R events and Fig. 5 rows, serve_kv's ``ServeReport``
counters, graph_pagerank's graph and top-8, and sharded_domain's strikes,
scrub totals and peer copies. The reference's example scripts themselves
are not run here: each takes minutes on the CPU.

Tolerances: none; every compared line is equal as text.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as jget_tiny
from repro.core import MemoryDomain as JDomain
from repro.core import ShardedMemoryDomain as JSharded
from repro.core import detect_recover as jdetect_recover
from repro.core import paper_design_availability as jdesign_availability
from repro.core import paper_design_costs as jdesign_costs
from repro.core import peer_dr_l as jpeer_dr_l
from repro.core import typical_server as jtypical_server
from repro.graph import graph_state as jgraph_state
from repro.graph import pagerank as jpagerank
from repro.graph import powerlaw_graph as jpowerlaw_graph
from repro.graph import top_k as jtop_k
from repro.runtime.serve_loop import serve_batch as jserve_batch
from repro_torch.configs import get_tiny
from repro_torch.convert import state_to_numpy
from repro_torch.core import tracegen
from repro_torch.draws import Stream
from repro_torch.examples import (characterize, graph_pagerank, quickstart,
                                  serve_kv, sharded_domain, train_hrm)
from repro_torch.launch import mesh as tmesh
from repro_torch.models import init_params

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def jparams():
    """The examples' tiny llama3-8b parameters (``init_params`` seed 0),
    as the reference's arrays."""
    p = init_params(get_tiny("llama3-8b"), seed=0, device="cpu")
    return jax.tree.map(jnp.asarray, state_to_numpy(p))


def _run(module, argv, capsys):
    assert module.main(argv) == 0
    return capsys.readouterr().out.splitlines()


def _line(lines, prefix):
    (hit,) = [ln for ln in lines if ln.startswith(prefix)]
    return hit


def test_quickstart_prints_what_the_reference_computes(jparams, capsys):
    lines = _run(quickstart, CPU, capsys)
    assert lines[-1] == "QUICKSTART OK"
    assert _line(lines, "bit-exact restore:") == "bit-exact restore: True"
    dom = JDomain.protect(jparams, jtypical_server())
    rng = np.random.default_rng(7)
    bad, events = dom.inject(rng, 1)
    assert _line(lines, "struck:") == f"struck: {events[0]['path']}"
    _, report = bad.scrub()
    assert _line(lines, "scrub report:") == \
        "scrub report: corrected=%d uncorrectable=%d" % report.totals()
    assert report.totals() == (1, 0)
    par = JDomain.protect(jparams, jdetect_recover())
    clean = {p: par.leaf(p) for p in par.paths()}
    bad2, _ = par.inject(rng, 1)
    scrubbed, rep = bad2.scrub()
    _, rec = scrubbed.recover(rep, clean_copy=lambda p: clean[p])
    assert _line(lines, "Par+R events:") == f"Par+R events: {rec}"
    costs, avail = jdesign_costs(), jdesign_availability()
    rows = [f"  {n:18s} server_saving={costs[n].server_saving:6.2%} "
            f"availability={avail[n].availability:.4%}" for n in costs]
    assert [ln for ln in lines if "server_saving=" in ln] == rows


def test_serve_kv_counters_equal_the_reference(jparams, capsys):
    lines = _run(serve_kv, CPU, capsys)
    assert lines[-1] == "SERVE_KV OK"
    prompts = Stream(1, "cpu").randint(get_tiny("llama3-8b").vocab_size,
                                       (4, 16))
    policy = jdetect_recover()
    object.__setattr__(policy, "scrub_interval", 4)
    toks, r = jserve_batch(jget_tiny("llama3-8b"), jparams,
                           jnp.asarray(prompts.numpy()), max_new_tokens=12,
                           policy=policy, error_rate_per_token=0.5, seed=9)
    assert toks.shape == (4, 12)
    assert _line(lines, "queries=") == (
        f"queries={r.queries} tokens={r.tokens_emitted} "
        f"injected={r.injected} detected={r.scrub_detected} "
        f"corrected={r.scrub_corrected} "
        f"sidecar_overhead={r.sidecar_overhead:.2%}")
    assert r.injected > 0 and r.scrub_detected > 0


def test_graph_pagerank_graph_and_top8_equal_the_reference(capsys):
    lines = _run(graph_pagerank, CPU, capsys)
    assert lines[-1] == "GRAPH_PAGERANK OK"
    g = jpowerlaw_graph(512, avg_degree=8, seed=0)
    assert _line(lines, "graph:") == (f"graph: n={g.n} edges={g.n_edges} "
                                      f"max_in_degree={g.max_in_degree}")
    _, rank, _ = jpagerank(jgraph_state(g), g.n, iters=25,
                           backend="segment_sum")
    top = re.match(r"top-8: (\[.*\]) residual", _line(lines, "top-8:"))
    assert top.group(1) == str(np.asarray(jtop_k(rank, g.n, 8)).tolist())
    assert "scrub corrected=1" in _line(lines, "topology strike")


def test_train_hrm_small_trains_through_the_drill(capsys):
    lines = _run(train_hrm, ["--small", *CPU], capsys)
    assert lines[-1] == "TRAIN_HRM OK"
    assert _line(lines, "restarts (node fail):").split()[-1] == "1"


def test_characterize_iid_and_trace(tmp_path, capsys):
    lines = _run(characterize, CPU, capsys)
    assert lines[-1] == "CHARACTERIZE OK"
    assert sum(ln.startswith("=== ") for ln in lines) == 3
    month = tmp_path / "month.npz"
    assert tracegen.main(["--out", str(month), "--events", "60"]) == 0
    capsys.readouterr()
    lines = _run(characterize, ["--trace", str(month), "--max-events", "20",
                                *CPU], capsys)
    assert lines[-1] == "CHARACTERIZE TRACE OK"
    assert lines[0].startswith("replaying ErrorTrace(60 events")
    assert sum(ln.startswith("overall:") for ln in lines) == 3


def test_sharded_domain_virtual_equals_the_reference(jparams, capsys):
    lines = _run(sharded_domain, ["--placement", "virtual", *CPU], capsys)
    assert lines[-1] == "SHARDED SMOKE OK"
    sh = JSharded.protect(jparams, jpeer_dr_l(), n_replicas=2, n_shards=4)
    assert lines[0] == repr(sh)
    phys = sh.physical_stats()
    assert lines[1] == (
        f"fleet: {phys['n_replicas']} replicas x {phys['n_shards']} "
        f"shards, {phys['payload_bytes'] / 1e6:.1f} MB payload "
        f"(+{phys['sidecar_bytes'] / 1e6:.2f} MB sidecar)")
    sh, events = sh.inject(np.random.default_rng(7), 3, replica=0)
    assert _line(lines, "struck:") == \
        f"struck: {[(e['replica'], e['path']) for e in events]}"
    sh, report = sh.scrub()
    c, u = report.totals()
    assert _line(lines, "aggregated scrub:") == \
        f"aggregated scrub: corrected={c} detected_uncorrectable={u}"
    _, rec = sh.recover(report)
    assert [ln for ln in lines if ln.startswith("  peer_copy:")] == [
        f"  {e['action']}: replica{e['replica']}/{e['path']} "
        f"<- replica{e['donor']}" for e in rec]
    assert _line(lines, "bit-exact peer restore:").endswith("True")


def test_sharded_domain_mesh_needs_eight_cards(monkeypatch):
    """The default placement raises when fewer than 8 CUDA devices are
    visible, and never runs virtually instead; it refuses ``--device``,
    which it would not use."""
    monkeypatch.setattr(tmesh.torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 8 CUDA devices; 1"):
        sharded_domain.main([])
    with pytest.raises(ValueError, match="needs 8 CUDA devices"):
        sharded_domain.main(["--placement", "mesh"])
    with pytest.raises(SystemExit):
        sharded_domain.main(["--placement", "mesh", *CPU])


@pytest.mark.parametrize("module", [quickstart, serve_kv, graph_pagerank,
                                    train_hrm, characterize],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_examples_need_a_device_without_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main([])

"""Graph workload of the PyTorch port against the JAX reference
(``repro.graph``) on the CPU: the generator, the bucketing and the graph
state bit for bit; PageRank and BFS, dense, node-blocked and
frontier-sparse; ``MemoryDomain.scrub_partial`` byte for byte at every
cursor; the scrubbed loops and the Fig. 2 ``eval_fn``s.

The reference runs as its own tests run it: Pallas in interpret mode on the
CPU. The port's wrappers run their plain versions. Tolerances: ranks are
held to rtol 1e-5 and atol 1e-7 x max|rank| (the push sums in another
order), top-k rankings, BFS distances, scrub payloads, sidecars and counts
exactly.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import graph as jgraph
from repro.configs import get_tiny as jget_tiny
from repro.core import MemoryDomain as JDomain
from repro.core.policy import DESIGN_POINTS as JDESIGN_POINTS
from repro.core.policy import HRMPolicy as JPolicy
from repro.core.tiers import Tier as JTier
from repro.models import init_params as jinit_params
from repro.models.transformer import init_cache as jinit_cache
from repro_torch import graph as tgraph
from repro_torch.convert import (sidecar_to_numpy, state_from_numpy,
                                 state_to_numpy)
from repro_torch.core import DESIGN_POINTS, HRMPolicy, MemoryDomain, Tier

RTOL = 1e-5
CPU = "cpu"


@pytest.fixture(scope="module")
def graphs():
    return (jgraph.powerlaw_graph(500, avg_degree=6, seed=2),
            tgraph.powerlaw_graph(500, avg_degree=6, seed=2))


def _states(graphs, **kw):
    jg, tg = graphs
    return (jgraph.graph_state(jg, **kw),
            tgraph.graph_state(tg, device=CPU, **kw))


@pytest.fixture(scope="module")
def blocked(graphs):
    return _states(graphs, with_bfs=True, source=0, node_block=128,
                   edge_tile=128)


@pytest.fixture(scope="module")
def dense(graphs):
    return _states(graphs, with_bfs=True, source=0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _same_tree(want: dict, got: dict) -> None:
    """Nested dicts of numpy arrays: the same keys, dtypes, shapes and
    values."""
    assert set(want) == set(got)
    for k in want:
        if isinstance(want[k], dict):
            _same_tree(want[k], got[k])
        else:
            assert want[k].dtype == got[k].dtype, k
            assert want[k].shape == got[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    atol = 1e-7 * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=atol)


# ------------------------------------------------------------ generator
@pytest.mark.parametrize("n,avg,seed,vectorized", [
    (500, 6, 2, None), (96, 8, 7, None), (64, 8, 3, None),
    (4096, 8, 0, None), (5000, 16, 3, None), (512, 8, 4, True),
    (300, 4, 9, False)])
def test_powerlaw_graph_matches_reference(n, avg, seed, vectorized):
    want = jgraph.powerlaw_graph(n, avg_degree=avg, seed=seed,
                                 vectorized=vectorized)
    got = tgraph.powerlaw_graph(n, avg_degree=avg, seed=seed,
                                vectorized=vectorized)
    assert got.n == want.n and got.n_edges == want.n_edges
    assert got.max_in_degree == want.max_in_degree
    for name in ("indptr", "indices", "out_degree"):
        a, b = getattr(want, name), getattr(got, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("n,size,seed", [(1, 5, 0), (7, 1000, 1),
                                         (4096, 65536, 2),
                                         (100_000, 400_000, 3)])
def test_choice_draws_what_numpy_draws(n, size, seed):
    """The generator's parallel inverse-CDF lookup gives the draws of
    ``rng.choice(n, size, p=p)`` and leaves the stream where it does."""
    from repro_torch.graph.generate import _choice
    w = np.random.default_rng(seed + 100).random(n) ** 4
    w[::3] = 0.0 if n > 2 else w[::3]
    p = w / w.sum()
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    want = a.choice(n, size=size, p=p)
    got = _choice(b, n, size, p)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert a.random() == b.random()


@pytest.mark.parametrize("seed,n_pad,bn,te,e", [
    (0, 512, 128, 128, 1000), (1, 1024, 256, 512, 3000),
    (2, 256, 128, 128, 0), (3, 65536, 8192, 512, 20000)])
def test_bucket_edges_matches_reference(seed, n_pad, bn, te, e):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_pad, e)
    dst = rng.integers(0, n_pad, e)
    want = jgraph.bucket_edges(src, dst, n_pad, bn, edge_tile=te)
    got = tgraph.bucket_edges(src, dst, n_pad, bn, edge_tile=te)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("kw", [
    {}, {"with_bfs": True, "source": 3}, {"edge_tile": 256},
    {"node_block": 128, "edge_tile": 128},
    {"node_block": 256, "with_bfs": True, "source": 499},
    {"with_bfs": True, "source": 512}], ids=str)
def test_graph_state_matches_reference(graphs, kw):
    """Leaf by leaf through numpy, int32 leaves included; ``convert``
    carries the reference's state into the port unchanged."""
    jst, tst = _states(graphs, **kw)
    want = _np(jst)
    _same_tree(want, state_to_numpy(tst))
    _same_tree(want, state_to_numpy(state_from_numpy(want, device=CPU)))
    assert tgraph.n_padded(tst) == jgraph.n_padded(jst)
    assert tgraph.node_block_of(tst) == jgraph.node_block_of(jst)


def test_graph_state_rejects_a_ragged_block(graphs):
    with pytest.raises(ValueError):
        tgraph.graph_state(graphs[1], node_block=100, device=CPU)


# ------------------------------------------------------------- PageRank
@pytest.mark.parametrize("layout", ["dense", "blocked"])
def test_pagerank_matches_reference(graphs, dense, blocked, layout):
    jst, tst = {"dense": dense, "blocked": blocked}[layout]
    n = graphs[0].n
    _, jr, jd = jgraph.pagerank(jst, n, iters=10, backend="pallas")
    _, jr_ref, _ = jgraph.pagerank(jst, n, iters=10, backend="segment_sum")
    golden = np.asarray(jgraph.top_k(jr, n, 8))
    for backend in tgraph.BACKENDS:
        _, tr, td = tgraph.pagerank(tst, n, iters=10, backend=backend)
        _close(tr, jr)
        _close(tr, jr_ref)
        np.testing.assert_allclose(float(td), float(jd), rtol=1e-3)
        np.testing.assert_array_equal(tgraph.top_k(tr, n, 8).numpy(),
                                      golden)
    _, tf, _ = tgraph.pagerank(tst, n, iters=10, fori=True)
    assert torch.equal(tf, tr)


def test_pagerank_blocked_equals_dense(graphs, dense, blocked):
    n = graphs[1].n
    _, rd, _ = tgraph.pagerank(dense[1], n, iters=10)
    _, rb, _ = tgraph.pagerank(blocked[1], n, iters=10)
    m = min(rd.shape[1], rb.shape[1])
    _close(rb[:, :m], rd[:, :m].numpy())
    assert torch.equal(tgraph.top_k(rb, n, 8), tgraph.top_k(rd, n, 8))


def test_pagerank_rejects_an_unknown_backend(dense, graphs):
    with pytest.raises(ValueError):
        tgraph.pagerank(dense[1], graphs[1].n, iters=1, backend="oracle")


# ------------------------------------------------------------------ BFS
@pytest.mark.parametrize("layout,source", [("dense", 0), ("blocked", 0),
                                           ("blocked", 7)])
def test_bfs_matches_reference(graphs, layout, source):
    kw = {"node_block": 128, "edge_tile": 128} if layout == "blocked" \
        else {}
    jst, tst = _states(graphs, with_bfs=True, source=source, **kw)
    jg, tg = graphs
    _, jdist = jgraph.bfs(jst, backend="pallas")
    want = np.asarray(jdist)
    golden = np.asarray(jgraph.bfs_reference(jg, source))
    np.testing.assert_array_equal(tgraph.bfs_reference(tg, source).numpy(),
                                  golden)
    for backend in tgraph.BACKENDS:
        for sparse in (None, False):
            state, dist = tgraph.bfs(tst, backend=backend, sparse=sparse)
            assert dist.dtype == torch.int32
            np.testing.assert_array_equal(dist.numpy(), want)
            np.testing.assert_array_equal(dist[0, :tg.n].numpy(), golden)
    _same_tree(_np(jgraph.bfs(jst, backend="pallas")[0]["frontier"]),
               state_to_numpy(state["frontier"]))


def test_bfs_sparse_pads_to_a_power_of_two(blocked, monkeypatch):
    """The sparse push keeps the reference's dispatch: kept tiles padded
    to a power of two with inert sentinel tiles."""
    tbfs = sys.modules["repro_torch.graph.bfs"]
    orig = tbfs.edge_segment_push_blocked
    calls = []

    def spy(src, dst, sb, db, x, *, node_block):
        calls.append(sb.shape[0])
        return orig(src, dst, sb, db, x, node_block=node_block)

    monkeypatch.setattr(tbfs, "edge_segment_push_blocked", spy)
    _, dist = tgraph.bfs(blocked[1])
    monkeypatch.undo()
    tiles = blocked[1]["topology"]["blocks"]["src_block"].shape[0]
    assert len(calls) == int(dist.max()) + 1
    assert all(c & (c - 1) == 0 for c in calls)
    assert max(calls) <= 1 << (tiles - 1).bit_length()


# ------------------------------------------------------ scrub_partial
def _same_domain(jdom, tdom):
    jflat = jax.tree_util.tree_flatten_with_path(jdom.payload)[0]
    assert len(jflat) == len(tdom.paths())
    for (path, leaf), p in zip(jflat, tdom.paths()):
        a = np.ascontiguousarray(np.asarray(leaf)).view(np.uint8)
        b = np.ascontiguousarray(state_to_numpy({"x": tdom.leaf(p)})["x"])
        np.testing.assert_array_equal(b.view(np.uint8), a, err_msg=p)
    _same_tree(_np(jdom.sidecar), sidecar_to_numpy(tdom.sidecar))


def _counts(d):
    return {k: int(np.asarray(v)) for k, v in d.items()}


def _same_report(jrep, trep):
    assert list(trep.corrected) == sorted(trep.corrected)
    assert _counts(trep.corrected) == _counts(jrep.corrected)
    assert _counts(trep.detected_uncorrectable) == \
        _counts(jrep.detected_uncorrectable)


def _cycle(jdom, tdom, slices, paths=None):
    """Every cursor of one cycle on both domains, compared after each;
    then the cycle against one ``scrub`` of the port."""
    jpart, tpart = jdom, tdom
    for c in range(slices):
        jpart, jrep = jpart.scrub_partial(c, slices=slices, paths=paths)
        tpart, trep = tpart.scrub_partial(c, slices=slices, paths=paths)
        _same_report(jrep, trep)
        _same_domain(jpart, tpart)
    full, _ = tdom.scrub(paths=paths)
    for p in full.paths():
        assert torch.equal(full.leaf(p), tpart.leaf(p)), p
    _same_tree(sidecar_to_numpy(full.sidecar),
               sidecar_to_numpy(tpart.sidecar))
    return tpart


@pytest.mark.parametrize("policy,slices", [("typical_server", 4),
                                           ("detect_recover_l", 3),
                                           ("mirror_dr_l", 5)])
def test_scrub_partial_on_a_struck_graph(blocked, policy, slices):
    jst, tst = blocked
    jdom = JDomain.protect({"graph": jst}, JDESIGN_POINTS[policy]())
    tdom = MemoryDomain.protect({"graph": tst}, DESIGN_POINTS[policy]())
    jdom, jev = jdom.inject(np.random.default_rng(11), 6,
                            multi_bit_fraction=0.0)
    tdom, tev = tdom.inject(np.random.default_rng(11), 6,
                            multi_bit_fraction=0.0)
    assert jev == tev
    _same_domain(jdom, tdom)
    _cycle(jdom, tdom, slices)


def test_scrub_partial_on_a_struck_model_state():
    """A ``{params, kv_cache}`` state under SEC-DED, MIRROR, PARITY_R and
    NONE regions, over every cursor and over a path subset."""
    cfg = jget_tiny("llama3-8b")
    cache = jinit_cache(cfg, 2, 16)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    cache = {k: jax.random.normal(key, v.shape).astype(v.dtype)
             for key, (k, v) in zip(keys, sorted(cache.items()))}
    jstate = {"params": jinit_params(jax.random.PRNGKey(0), cfg),
              "kv_cache": cache}
    tiers = {"params/embed": "secded", "params/attn": "mirror",
             "params/mlp": "parity_r", "params/norm": "none",
             "kv_cache": "secded"}
    jdom = JDomain.protect(jstate, JPolicy(
        "mixed", {r: JTier(t) for r, t in tiers.items()}))
    tdom = MemoryDomain.protect(state_from_numpy(_np(jstate), device=CPU),
                                HRMPolicy("mixed", {r: Tier(t) for r, t
                                                    in tiers.items()}))
    jdom, _ = jdom.inject(np.random.default_rng(5), 24,
                          multi_bit_fraction=0.0)
    tdom, _ = tdom.inject(np.random.default_rng(5), 24,
                          multi_bit_fraction=0.0)
    _cycle(jdom, tdom, 3)
    subset = [p for p in tdom.paths(protected_only=True)
              if "attn" in p or "kv_cache" in p]
    _cycle(jdom, tdom, 2, paths=subset)
    one, rep = tdom.scrub_partial(5, slices=1, paths=subset)
    assert set(rep.corrected) | set(rep.detected_uncorrectable) == \
        set(subset)


# ---------------------------------------------------- scrubbed loops
def test_scrubbed_loops_match_reference(graphs, blocked):
    jst, tst = blocked
    n = graphs[0].n
    topo = [p for p in MemoryDomain.protect(
        {"graph": tst}, DESIGN_POINTS["detect_recover_l"]()).paths(True)
        if "topology" in p]

    def domains():
        jdom = JDomain.protect({"graph": jst},
                               JDESIGN_POINTS["detect_recover_l"]())
        tdom = MemoryDomain.protect({"graph": tst},
                                    DESIGN_POINTS["detect_recover_l"]())
        jdom, _ = jdom.inject(np.random.default_rng(13), 2, paths=topo,
                              multi_bit_fraction=0.0)
        tdom, _ = tdom.inject(np.random.default_rng(13), 2, paths=topo,
                              multi_bit_fraction=0.0)
        return jdom, tdom

    jdom, tdom = domains()
    jdom, jr, _, jrep = jgraph.pagerank_scrubbed(jdom, n, iters=7,
                                                 scrub_slices=3)
    tdom, tr, _, trep = tgraph.pagerank_scrubbed(tdom, n, iters=7,
                                                 scrub_slices=3)
    _close(tr, jr)
    _same_report(jrep, trep)
    np.testing.assert_array_equal(tgraph.top_k(tr, n, 8).numpy(),
                                  np.asarray(jgraph.top_k(jr, n, 8)))
    for p in topo:
        np.testing.assert_array_equal(tdom.leaf(p).numpy(),
                                      np.asarray(jdom.leaf(p)), err_msg=p)

    jdom, tdom = domains()
    jdom, jdist, jrep = jgraph.bfs_scrubbed(jdom, scrub_slices=3)
    tdom, tdist, trep = tgraph.bfs_scrubbed(tdom, scrub_slices=3)
    np.testing.assert_array_equal(tdist.numpy(), np.asarray(jdist))
    _same_report(jrep, trep)
    _same_domain(jdom, tdom)


# ------------------------------------------------------------ eval_fn
def test_eval_fns_match_reference(graphs, dense):
    jst, tst = dense
    n = graphs[0].n
    jtok, _ = jgraph.pagerank_eval_fn(n, iters=12)({"graph": jst})
    ttok, out = tgraph.pagerank_eval_fn(n, iters=12)({"graph": tst})
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert set(out) == {"graph"}
    jdist, _ = jgraph.bfs_eval_fn(n)({"graph": jst})
    tdist, _ = tgraph.bfs_eval_fn(n)({"graph": tst})
    np.testing.assert_array_equal(tdist.numpy(), np.asarray(jdist))
    assert int(tdist.min()) >= 0 and int(tdist.max()) <= n


@pytest.mark.parametrize("value", [np.nan, np.inf])
def test_eval_fn_crash_marker(graphs, dense, value):
    """A non-finite rank answers with the -1 crash marker in both
    packages, though the port spreads it only along edges (the Pallas
    one-hot form spreads it to every node)."""
    jst, tst = dense
    n = graphs[0].n
    hub = int(np.argmax(graphs[0].out_degree))
    rank = np.asarray(jst["rank"]["rank"]).copy()
    rank[0, hub] = value
    jtok, _ = jgraph.pagerank_eval_fn(n)(
        {"graph": {**jst, "rank": {"rank": jnp.asarray(rank)}}})
    ttok, _ = tgraph.pagerank_eval_fn(n)(
        {"graph": {**tst, "rank": {"rank": torch.from_numpy(rank)}}})
    assert np.asarray(jtok).tolist() == [-1] * 8
    assert ttok.tolist() == [-1] * 8

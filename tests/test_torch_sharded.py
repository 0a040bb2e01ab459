"""The port's sharded memory domains against the JAX reference on the CPU:
``ShardedMemoryDomain`` (partition, stats, strikes, per-shard and merged
scrub reports, peer-copy recovery with its disk fallback, restarts and
per-replica retirement) and ``launch.mesh``, on tiny llama3-8b with the
reference's parameters carried across through numpy.

Tolerances: none. The reference runs in virtual mode with its kernels in
Pallas interpret mode, as ``tests/test_sharded.py`` runs it; every
partition, count, event, retired block and restored byte must be equal.
Mesh placement runs on hand-built CPU grids (torch has one ``cpu``
device, so a grid names it in every cell).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_tiny as jget_tiny
from repro.core import HRMPolicy as JPolicy
from repro.core import InjectionPlan as JPlan
from repro.core import Response as JResponse
from repro.core import RestartRequired as JRestartRequired
from repro.core import RetirementMap as JRetirementMap
from repro.core import ShardedMemoryDomain as JSharded
from repro.core import Tier as JTier
from repro.core import typical_server as jtypical_server
from repro.models import init_params as jinit_params
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import (HRMPolicy, InjectionPlan, MemoryDomain,
                              Response, RestartRequired, RetirementMap,
                              ScrubReport, ShardedMemoryDomain, Tier, tree,
                              typical_server)
from repro_torch.core import sidecar
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import DomainMesh, make_domain_mesh, mesh_grid

POLICIES = {
    "typical_server": (typical_server, jtypical_server),
    "par_all": (lambda: HRMPolicy("par_all", {}, default=Tier.PARITY_R),
                lambda: JPolicy("par_all", {}, default=JTier.PARITY_R)),
}


@pytest.fixture(scope="module")
def pair():
    """(reference params, port params), the same bytes."""
    jp = jinit_params(jax.random.PRNGKey(0), jget_tiny("llama3-8b"))
    return jp, state_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _both(pair, policy, **kw):
    jp, p = pair
    port, ref = POLICIES[policy]
    return (ShardedMemoryDomain.protect(p, port(), **kw),
            JSharded.protect(jp, ref(), **kw))


def _np_leaves(state):
    """Leaves as numpy, in flatten order (bf16 as its bits)."""
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


def _same_state(tstate, jstate) -> bool:
    a = tree.leaves(state_to_numpy(tstate))
    b = _np_leaves(jstate)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and x.tobytes() == y.tobytes() for x, y in zip(a, b))


def _bits(state):
    return [x.tobytes() for x in tree.leaves(state_to_numpy(state))]


def _counts(rep):
    return ({k: int(np.asarray(v)) for k, v in rep.corrected.items()},
            {k: int(np.asarray(v))
             for k, v in rep.detected_uncorrectable.items()})


def _same_report(trep, jrep) -> bool:
    """Per-replica, per-shard and merged counts equal path for path."""
    return (len(trep.per_shard) == len(jrep.per_shard)
            and all(_counts(t) == _counts(j)
                    for trow, jrow in zip(trep.per_shard, jrep.per_shard)
                    for t, j in zip(trow, jrow))
            and all(_counts(t) == _counts(j)
                    for t, j in zip(trep.replicas, jrep.replicas))
            and _counts(trep.domain_report()) == _counts(jrep.domain_report())
            and trep.totals() == jrep.totals()
            and trep.needs_recovery() == jrep.needs_recovery())


def _strike_plans(sh, n=4, seed=7):
    """``tests/test_sharded.py``'s plans: one single-bit strike, at a word
    drawn from ``seed``, on each of the ``n`` largest protected leaves."""
    rng = np.random.default_rng(seed)
    size = {p: sh.leaf(p).numel() * sh.leaf(p).element_size()
            for p in sh.paths(protected_only=True)}
    paths = sorted(size, key=lambda p: (-size[p], p))[:n]
    return [(p, np.array([int(rng.integers(0, max(1, size[p] // 8)))],
                         np.int32),
             np.array([int(rng.integers(0, 64))], np.int32)) for p in paths]


def _apply(tsh, jsh, plans, replica=0):
    for path, w, b in plans:
        tsh = tsh.apply_plan(path, InjectionPlan(w, b, hard=False),
                             replica=replica)
        jsh = jsh.apply_plan(path, JPlan(w, b, hard=False), replica=replica)
    return tsh, jsh


# ------------------------------------------------ structure + partition
@pytest.mark.parametrize("n_shards", [2, 3])
def test_partition_and_structure_equal_reference(pair, n_shards):
    """``shard_of``, the flatten order, the paths, every leaf's region and
    tier, and both replicas' reassembled state equal the reference's."""
    tsh, jsh = _both(pair, "typical_server", n_replicas=2,
                     n_shards=n_shards)
    assert tsh.shard_of == jsh.shard_of
    assert set(tsh.shard_of.values()) == set(range(n_shards))
    assert tsh.order == jsh.order
    assert tsh.paths() == jsh.paths()
    assert tsh.paths(protected_only=True) == jsh.paths(protected_only=True)
    for p in jsh.paths():
        assert tsh.region_of(p) == jsh.region_of(p)
        assert tsh.tier_of(p).value == jsh.tier_of(p).value
    for r in range(2):
        assert _same_state(tsh.state(r), jsh.state(r))
        assert tree.structure(tsh.state(r)) == tree.structure(pair[1])
    assert (tsh.n_replicas, tsh.n_shards) == (jsh.n_replicas, jsh.n_shards)
    assert repr(tsh) == repr(jsh)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_stats_equal_reference(pair, policy):
    tsh, jsh = _both(pair, policy, n_replicas=2, n_shards=3)
    for r in range(2):
        assert dataclasses.asdict(tsh.stats(r)) == \
            dataclasses.asdict(jsh.stats(r))
    assert tsh.physical_stats() == jsh.physical_stats()
    assert tsh.region_profile().fractions == jsh.region_profile().fractions
    single = MemoryDomain.protect(pair[1], POLICIES[policy][0]())
    assert tsh.stats().payload_bytes == single.stats().payload_bytes
    assert tsh.physical_stats()["payload_bytes"] == \
        2 * single.stats().payload_bytes


# ----------------------------------------------------------- strikes
def test_inject_events_equal_reference(pair):
    """The same numpy stream strikes the same leaves, words and bits in
    both packages; hard strikes re-assert alike, on one replica only."""
    tsh, jsh = _both(pair, "typical_server", n_replicas=2, n_shards=2)
    tsh, tev = tsh.inject(np.random.default_rng(0), 5, replica=1)
    jsh, jev = jsh.inject(np.random.default_rng(0), 5, replica=1)
    assert tev == jev and len(tev) == 5
    assert all(e["replica"] == 1 for e in tev)
    assert _same_state(tsh.state(1), jsh.state(1))
    assert _bits(tsh.state(0)) == _bits(pair[1])      # replica 0 untouched
    par = tsh.paths(protected_only=True)[:4]
    tsh, tev = tsh.inject(np.random.default_rng(5), 3, replica=0,
                          hard=True, paths=par, multi_bit_fraction=0.0)
    jsh, jev = jsh.inject(np.random.default_rng(5), 3, replica=0,
                          hard=True, paths=par, multi_bit_fraction=0.0)
    assert tev == jev
    tsh, jsh = tsh.reassert_hard(replica=0), jsh.reassert_hard(replica=0)
    for r in range(2):
        assert _same_state(tsh.state(r), jsh.state(r))
    assert [tsh.stats(r).n_hard_errors for r in range(2)] == \
        [jsh.stats(r).n_hard_errors for r in range(2)]


# --------------------------------------------------- scrub and reports
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_scrub_reports_equal_reference(pair, policy):
    """Per-shard, per-replica and merged reports and the scrubbed payload
    equal the reference's, after plan strikes and drawn strikes."""
    tsh, jsh = _both(pair, policy, n_replicas=2, n_shards=3)
    tsh, jsh = _apply(tsh, jsh, _strike_plans(tsh))
    tsh, _ = tsh.inject(np.random.default_rng(11), 3, replica=1)
    jsh, _ = jsh.inject(np.random.default_rng(11), 3, replica=1)
    tfix, trep = tsh.scrub()
    jfix, jrep = jsh.scrub()
    assert _same_report(trep, jrep)
    assert sum(trep.totals()) >= 4
    for r in range(2):
        assert _same_state(tfix.state(r), jfix.state(r))
    # the re-encoded sidecars agree too: a refresh of everything and a
    # second scrub leave nothing to report in either package
    tfix, jfix = tfix.refresh(), jfix.refresh()
    _, trep2 = tfix.scrub()
    _, jrep2 = jfix.scrub()
    assert _same_report(trep2, jrep2) and trep2.totals()[1] == 0


# ------------------------------------------------------------ recovery
def test_recover_equals_reference(pair):
    """Peer copy, the disk path, escalation to retirement, the fallback to
    the clean copy when every replica is flagged, and the restarts: events,
    strike counts, retired blocks and restored bytes equal."""
    jp, p = pair
    tsh, jsh = _both(pair, "par_all", n_replicas=2, n_shards=3)
    plans = _strike_plans(tsh)
    t1, j1 = _apply(tsh, jsh, plans)
    t1, trep = t1.scrub()
    j1, jrep = j1.scrub()
    assert trep.needs_recovery() == jrep.needs_recovery()
    assert set(trep.needs_recovery()) == {0}

    tpeer, tev = t1.recover(trep)
    jpeer, jev = j1.recover(jrep)
    assert tev == jev
    assert all(e["action"] == "peer_copy" and e["donor"] == 1 for e in tev)
    assert _same_state(tpeer.state(0), jpeer.state(0))
    assert _bits(tpeer.state(0)) == _bits(p)

    tclean = dict(zip(tsh.order, tree.leaves(p)))
    jclean = dict(zip(jsh.order, _np_leaves(jp)))
    tdisk, tev = t1.recover(trep, clean_copy=tclean.__getitem__,
                            response=Response.RELOAD_CLEAN_COPY)
    jdisk, jev = j1.recover(jrep, clean_copy=jclean.__getitem__,
                            response=JResponse.RELOAD_CLEAN_COPY)
    assert tev == jev
    assert all(e["action"] == "reload_clean_copy" for e in tev)
    assert _same_state(tdisk.state(0), jdisk.state(0))

    # escalation: the damaged 512-byte blocks retire under replica 0's key
    path = plans[0][0]
    tstrikes = {f"replica0/{path}": 2}
    jstrikes = dict(tstrikes)
    tret, jret = RetirementMap(), JRetirementMap()
    tfix, tev = t1.recover(trep, strikes=tstrikes, retirement=tret,
                           retire_after=3)
    jfix, jev = j1.recover(jrep, strikes=jstrikes, retirement=jret,
                           retire_after=3)
    assert tev == jev and tstrikes == jstrikes
    assert [e["action"] for e in tev].count("peer_copy+retire") == 1
    assert tret.blocks == jret.blocks and tret.count() >= 1
    assert all(k.startswith("replica0/") for k in tret.blocks)
    assert _same_state(tfix.state(0), jfix.state(0))

    # CONSUME and RESTART responses
    assert t1.recover(trep, response=Response.CONSUME)[1] == \
        j1.recover(jrep, response=JResponse.CONSUME)[1]
    with pytest.raises(RestartRequired):
        t1.recover(trep, response=Response.RESTART)

    # every replica flagged: the clean copy, else a restart
    t2, j2 = _apply(tsh, jsh, plans[:2], replica=0)
    t2, j2 = _apply(t2, j2, plans[:2], replica=1)
    t2, trep2 = t2.scrub()
    j2, jrep2 = j2.scrub()
    assert set(trep2.needs_recovery()) == {0, 1}
    tfix, tev = t2.recover(trep2, clean_copy=tclean.__getitem__)
    jfix, jev = j2.recover(jrep2, clean_copy=jclean.__getitem__)
    assert tev == jev
    assert all(e["action"] == "reload_clean_copy" for e in tev)
    for r in range(2):
        assert _same_state(tfix.state(r), jfix.state(r))
        assert _bits(tfix.state(r)) == _bits(p)
    with pytest.raises(RestartRequired):
        t2.recover(trep2)
    with pytest.raises(JRestartRequired):
        j2.recover(jrep2)


# ------------------------------------------- the port against itself
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_sharded_scrub_bit_identical_to_single_device(pair, policy):
    """Same strikes, per-shard scrub + merged report against the unsharded
    domain: the same recovered payload and the same per-path counts."""
    p = pair[1]
    single = MemoryDomain.protect(p, POLICIES[policy][0]())
    sh = ShardedMemoryDomain.protect(p, POLICIES[policy][0](),
                                     n_replicas=2, n_shards=3)
    for path, w, b in _strike_plans(sh):
        plan = InjectionPlan(w, b, hard=False)
        single = single.apply_plan(path, plan)
        sh = sh.apply_plan(path, plan, replica=0)
    single_fixed, s_rep = single.scrub()
    sh_fixed, rep = sh.scrub()
    assert _bits(sh_fixed.state(0)) == _bits(single_fixed.payload)
    assert _bits(sh_fixed.state(1)) == _bits(p)
    agg = rep.domain_report()
    assert agg.totals() == s_rep.totals() == rep.totals()
    c, u = _counts(s_rep)
    assert _counts(agg) == (c, u)
    assert rep.needs_recovery().get(0, {}) == s_rep.needs_recovery()
    assert 1 not in rep.needs_recovery()
    assert sum(r.totals()[0] for row in rep.per_shard for r in row) == \
        s_rep.totals()[0]


def test_scrub_schedule_gate_and_subset(pair):
    policy = typical_server()
    object.__setattr__(policy, "scrub_interval", 10)
    sh = ShardedMemoryDomain.protect(pair[1], policy, n_replicas=1,
                                     n_shards=3)
    same, rep = sh.scrub(step=3)
    assert rep is None and same is sh
    assert sh.scrub(step=20)[1] is not None
    path = sh.paths(protected_only=True)[0]
    sub, rep = sh.scrub(paths=[path])
    assert set(rep.domain_report().corrected) == {path}
    untouched = [s for s in range(3) if s != sh.shard_of[path]]
    assert all(sub.shards[0][s] is sh.shards[0][s] for s in untouched)
    assert all(not rep.per_shard[0][s].corrected for s in untouched)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_strikes_spare_the_other_replica_and_the_original(pair, policy):
    """A strike on replica 0, its scrub and its recovery write into no
    tensor that replica 1, the caller's state or a clean copy holds; the
    leaves they return lie in storage of their own, so writing those in
    place reaches none of them either."""
    p = pair[1]
    before = _bits(p)
    sh = ShardedMemoryDomain.protect(p, POLICIES[policy][0](),
                                     n_replicas=2, n_shards=3)
    copies = dict(zip(sh.order, (t.clone() for t in tree.leaves(p))))
    sh, events = sh.inject(np.random.default_rng(3), 4, replica=0,
                           multi_bit_fraction=0.0)
    struck = {e["path"] for e in events}
    for path, w, b in _strike_plans(sh, n=2):
        sh = sh.apply_plan(path, InjectionPlan(w, b, hard=False), replica=0)
        struck.add(path)
    assert _bits(sh.state(1)) == before and _bits(p) == before
    sh, rep = sh.scrub()
    assert sum(rep.totals()) >= 4
    sh, _ = sh.recover(rep, clean_copy=copies.__getitem__)
    assert _bits(sh.state(0)) == before
    held = {t.untyped_storage().data_ptr()
            for t in tree.leaves(p) + list(copies.values())}
    fresh = [q for q in sh.order if sh.leaf(q, 0) is not sh.leaf(q, 1)]
    assert struck <= set(fresh)
    for leaf in (sh.leaf(q, 0) for q in fresh):
        assert leaf.untyped_storage().data_ptr() not in held
        leaf.view(torch.uint8).bitwise_not_()
    assert _bits(sh.state(1)) == before and _bits(p) == before
    assert _bits(dict(copies)) == _bits(dict(zip(sh.order,
                                                 tree.leaves(p))))


# --------------------------------------------------------- placement
def test_mesh_placement_on_a_cpu_grid_equals_virtual(pair):
    """Each cell's tensors lie on its grid device, and the verbs give what
    virtual mode gives."""
    p = pair[1]
    mesh = DomainMesh.of([["cpu"] * 3] * 2)
    placed = ShardedMemoryDomain.protect(p, typical_server(), mesh=mesh)
    virtual = ShardedMemoryDomain.protect(p, typical_server(), n_replicas=2,
                                          n_shards=3)
    assert (placed.n_replicas, placed.n_shards) == (2, 3)
    assert "placement=mesh" in repr(placed)
    assert placed.devices == tuple(tuple(torch.device("cpu")
                                         for _ in range(3))
                                   for _ in range(2))
    for r in range(2):
        for s in range(3):
            for leaf in tree.leaves(placed.shards[r][s].payload):
                assert leaf.device == placed.devices[r][s]
    assert placed.shard_of == virtual.shard_of
    out = []
    for sh in (placed, virtual):
        sh, ev = sh.inject(np.random.default_rng(2), 4, replica=1,
                           multi_bit_fraction=0.0)
        sh, rep = sh.scrub()
        out.append((ev, _counts(rep.domain_report()), _bits(sh.state(1))))
    assert out[0] == out[1]
    # axes in another order, and an extra axis, as the reference allows
    swapped = DomainMesh.of([["cpu"] * 2] * 3, ("model", "data"))
    assert mesh_grid(swapped).shape == (2, 3)
    pod = DomainMesh(np.array([[["cpu"] * 4] * 2] * 3, dtype=object),
                     ("pod", "data", "model"))
    assert mesh_grid(pod).shape == (2, 4)
    with pytest.raises(ValueError, match="exceeds the mesh"):
        ShardedMemoryDomain.protect(p, typical_server(), mesh=mesh,
                                    n_shards=4)
    with pytest.raises(ValueError, match="lack"):
        ShardedMemoryDomain.protect(p, typical_server(),
                                    mesh=DomainMesh.of([["cpu"]], ("a", "b")))


def test_make_domain_mesh_needs_enough_devices(monkeypatch):
    monkeypatch.setattr(tmesh.torch.cuda, "device_count", lambda: 7)
    with pytest.raises(ValueError, match="needs 8 CUDA devices; 7"):
        make_domain_mesh(2, 4)
    monkeypatch.setattr(tmesh.torch.cuda, "device_count", lambda: 8)
    m = make_domain_mesh(2, 4)
    assert m.axis_names == ("data", "model") and m.shape == (2, 4)
    assert [str(d) for d in m.devices.reshape(-1)] == \
        [f"cuda:{i}" for i in range(8)]
    monkeypatch.setattr(tmesh.torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError):
        make_domain_mesh(1, 1)


# ----------------------------------------------------- merged reports
def test_merged_folds_counts_with_one_sync_per_report(monkeypatch):
    """``ScrubReport.merged`` sums per path as ``int`` did, and fetches
    each report's counts in one call."""
    gen = np.random.default_rng(0)
    reports = []
    for _ in range(3):
        keys = ["a", "b", "c", "d"][:int(gen.integers(2, 5))]
        reports.append(ScrubReport(
            corrected={k: torch.tensor(int(gen.integers(0, 9)))
                       for k in keys},
            detected_uncorrectable={k: torch.tensor(int(gen.integers(0, 9)))
                                    for k in keys[1:]}))
    reports.append(ScrubReport())
    want_c, want_u = {}, {}
    for rep in reports:
        for k, v in rep.corrected.items():
            want_c[k] = want_c.get(k, 0) + int(v)
        for k, v in rep.detected_uncorrectable.items():
            want_u[k] = want_u.get(k, 0) + int(v)
    calls = []
    real = sidecar._host_counts
    monkeypatch.setattr(sidecar, "_host_counts",
                        lambda vals: calls.append(len(vals)) or real(vals))
    merged = ScrubReport.merged(reports)
    assert merged.corrected == want_c
    assert merged.detected_uncorrectable == want_u
    assert all(type(v) is int for v in merged.corrected.values())
    assert len(calls) == len(reports)

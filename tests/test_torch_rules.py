"""The port's sharding layer against the JAX reference on the CPU.

The rules (``repro_torch.sharding.rules``) read a mesh's axis names and
sizes only, and the reference's run in-process on a
``jax.sharding.AbstractMesh`` of the same sizes, so both are held at the
production meshes (SINGLE_POD 16x16, MULTI_POD 2x16x16) and at (2,4),
(4,2) and (1,1), for every config of the registry at its full size: the
port's trees come from ``init_params`` / ``init_cache`` on the ``meta``
device, the reference's from ``jax.eval_shape``. Specs, per-device shard
shapes and the mesh configs are compared exactly.

The per-group MoE dispatch (``_moe_apply_local``) and ``moe_apply`` under
``shard_hints`` are held to the reference's at tiny granite-moe-3b-a800m
and deepseek-moe-16b in float32 compute, within 1e-5 x max|y| (the two
frameworks sum the products in other orders), the aux loss within 1e-6
relative; the train step under ``shard_hints`` with an ambient mesh to the
port's ``shard_hints`` step without one (bit for bit), and to its plain
step and the reference's at ``tests/test_torch_train.py``'s tolerances.
jax 0.9's ``make_mesh`` makes ``Explicit`` axes, under which the
reference's ``hint`` refuses any spec, so its device meshes here are
built with ``Auto`` axes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding as JNamedSharding

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.configs import get_tiny as jget_tiny
from repro.configs import list_archs as jlist_archs
from repro.data import synthetic as jsyn
from repro.launch import mesh as jmesh
from repro.models import mlp as jmlp
from repro.models.transformer import init_cache as jinit_cache
from repro.models.transformer import init_params as jinit_params
from repro.runtime.steps import init_train_state as jinit_train_state
from repro.runtime.steps import make_train_step as jmake_train_step
from repro.sharding import rules as jrules
from repro_torch.configs import (MULTI_POD, SINGLE_POD, MeshConfig,
                                 TrainConfig, get_config, get_tiny)
from repro_torch.convert import state_from_numpy
from repro_torch.core import tree
from repro_torch.data import synthetic
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import DomainMesh
from repro_torch.models import init_cache, init_params, mlp
from repro_torch.runtime.steps import make_train_step
from repro_torch.sharding import rules
from repro_torch.sharding.mesh import AbstractMesh, ambient_mesh

CPU = "cpu"
MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((1, 1), ("data", "model")))
CACHE_BATCH, CACHE_SEQ = 128, 32768
MOE_ARCHS = ("granite-moe-3b-a800m", "deepseek-moe-16b")
Y_REL, AUX_RTOL = 1e-5, 1e-6
# the reference's MoE paths jitted (its eager dispatch compiles op by op)
jmoe_local = jax.jit(jmlp._moe_apply_local, static_argnums=(2, 3, 4))
jmoe_apply = jax.jit(jmlp.moe_apply, static_argnums=(2,))
jmoe_global = jax.jit(jmlp._moe_apply_global, static_argnums=(2,))


def _auto_mesh(shape, axes=("data", "model")):
    """A device mesh whose axes are all ``Auto``: jax 0.9's ``make_mesh``
    makes ``Explicit`` axes by default, under which
    ``with_sharding_constraint`` (the reference's ``hint``) refuses a
    spec."""
    return jax.make_mesh(shape, axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


def _meshes():
    return [(JAbstractMesh(s, a), AbstractMesh(s, a)) for s, a in MESHES]


def _jflat(t):
    return [(tuple(str(getattr(e, "key", e)) for e in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]]


@pytest.fixture(scope="module")
def full_trees():
    """arch -> (reference eval_shape leaves, port meta leaves), made once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jp = jax.eval_shape(lambda: jinit_params(
                jax.random.PRNGKey(0), jget_config(arch)))
            p = init_params(get_config(arch), device="meta")
            cache[arch] = (jp, p)
        return cache[arch]
    return get


# ------------------------------------------------------------ parameters
@pytest.mark.parametrize("arch", jlist_archs())
def test_param_specs_equal_reference(arch, full_trees):
    """Every leaf's spec, with and without ``tp_only``, and its per-device
    shard shape on five meshes; ``param_shardings`` and ``opt_shardings``
    (moments ``m``, ``v`` and the replicated ``count``) leaf for leaf."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jp, p = full_trees(arch)
    jleaves, leaves = _jflat(jp), tree.flatten_with_path(p)[0]
    assert [k for k, _ in jleaves] == [k for k, _ in leaves]
    for jm, m in _meshes():
        for tp_only in (False, True):
            for (jpath, jleaf), (path, leaf) in zip(
                    jax.tree_util.tree_flatten_with_path(jp)[0], leaves):
                want = jrules.param_spec(jpath, jleaf.shape, jm, jcfg,
                                         tp_only=tp_only)
                got = rules.param_spec(path, tuple(leaf.shape), m, cfg,
                                       tp_only=tp_only)
                assert tuple(got) == tuple(want), (path, m.axis_sizes, tp_only)
                assert rules.NamedSharding(m, got).shard_shape(
                    tuple(leaf.shape)) == \
                    JNamedSharding(jm, want).shard_shape(jleaf.shape)
            got = tree.leaves(rules.param_shardings(p, m, cfg,
                                                    tp_only=tp_only))
            want = jax.tree.leaves(jrules.param_shardings(jp, jm, jcfg,
                                                          tp_only=tp_only))
            assert [tuple(s.spec) for s in got] == \
                [tuple(s.spec) for s in want]
        want = jrules.opt_shardings(None, jp, jm, jcfg)
        got = rules.opt_shardings(None, p, m, cfg)
        assert sorted(got) == sorted(want) == ["count", "m", "v"]
        assert tuple(got["count"].spec) == tuple(want["count"].spec) == ()
        for k in ("m", "v"):
            assert [tuple(s.spec) for s in tree.leaves(got[k])] == \
                [tuple(s.spec) for s in jax.tree.leaves(want[k])]


def test_full_size_shard_shapes_need_the_mesh():
    """What the placements are for: llama3-405b's FSDP layout on SINGLE_POD
    leaves no parameter shard above 80 GB / 256, and a spec that does not
    divide its dim raises in both packages."""
    cfg = get_config("llama3-405b")
    p = init_params(cfg, device="meta")
    m = AbstractMesh(SINGLE_POD.shape, SINGLE_POD.axes)
    sh = rules.param_shardings(p, m, cfg)
    per_device = sum(
        int(np.prod(s.shard_shape(tuple(leaf.shape)))) * leaf.element_size()
        for s, leaf in zip(tree.leaves(sh), tree.leaves(p)))
    total = sum(t.numel() * t.element_size() for t in tree.leaves(p))
    assert total == 811_706_777_600 and per_device < total // 200
    jm = JAbstractMesh((2, 4), ("data", "model"))
    with pytest.raises(ValueError):
        JNamedSharding(jm, jax.sharding.PartitionSpec("model")).shard_shape(
            (6,))
    with pytest.raises(ValueError):
        rules.NamedSharding(AbstractMesh((2, 4), ("data", "model")),
                            rules.P("model")).shard_shape((6,))


# ---------------------------------------------------------------- caches
@pytest.mark.parametrize("arch", [a for a in jlist_archs()
                                  if jget_config(a).is_decoder])
def test_cache_specs_equal_reference(arch):
    """The decode cache at batch 128 x 32,768 positions: KV, Mamba2 and
    mLSTM/sLSTM states, with and without ``seq_shard``."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jc = jax.eval_shape(lambda: jinit_cache(jcfg, CACHE_BATCH, CACHE_SEQ))
    c = init_cache(cfg, CACHE_BATCH, CACHE_SEQ, device="meta")
    leaves = tree.flatten_with_path(c)[0]
    jleaves = jax.tree_util.tree_flatten_with_path(jc)[0]
    assert [k for k, _ in _jflat(jc)] == [k for k, _ in leaves]
    keys = {k[-1] for k, _ in leaves}
    assert keys == {"hybrid": {"mamba_conv", "mamba_ssm", "attn_k", "attn_v"},
                    "ssm": {"m_conv", "m_c", "s_c", "s_n", "s_h", "s_m"}
                    }.get(cfg.family, {"k", "v"})
    for jm, m in _meshes():
        for seq_shard in (False, True):
            for (jpath, jleaf), (path, leaf) in zip(jleaves, leaves):
                want = jrules.cache_spec(jpath, jleaf.shape, jm, jcfg,
                                         seq_shard)
                got = rules.cache_spec(path, tuple(leaf.shape), m, cfg,
                                       seq_shard)
                assert tuple(got) == tuple(want), \
                    (path, m.axis_sizes, seq_shard)
                assert rules.NamedSharding(m, got).shard_shape(
                    tuple(leaf.shape)) == \
                    JNamedSharding(jm, want).shard_shape(jleaf.shape)
            got = tree.leaves(rules.cache_shardings(c, m, cfg, seq_shard))
            want = jax.tree.leaves(jrules.cache_shardings(jc, jm, jcfg,
                                                          seq_shard))
            assert [tuple(s.spec) for s in got] == \
                [tuple(s.spec) for s in want]


# --------------------------------------------------------------- batches
@pytest.mark.parametrize("batch", (8, 6, 3))
def test_batch_shardings_equal_reference(batch):
    """``lm_batch``, ``audio_batch`` and ``vlm_batch`` of tiny configs: the
    batch dim on the data axes where they divide it."""
    for arch, make, seq in (("llama3-8b", "lm_batch", 16),
                            ("hubert-xlarge", "audio_batch", 16),
                            ("llava-next-mistral-7b", "vlm_batch", 16)):
        jb = getattr(jsyn, make)(jget_tiny(arch), batch, seq, 0)
        b = getattr(synthetic, make)(get_tiny(arch), batch, seq, 0,
                                     device=CPU)
        for jm, m in _meshes():
            want = {k: tuple(v.spec) for k, v in
                    jrules.batch_shardings(jb, jm).items()}
            got = {k: tuple(v.spec) for k, v in
                   rules.batch_shardings(b, m).items()}
            assert got == want, (arch, m.axis_sizes)
            assert rules.replicated(m).spec == ()


# ----------------------------------------------------------- mesh configs
def test_mesh_configs_and_meshes(monkeypatch):
    """``MeshConfig``, ``SINGLE_POD``, ``MULTI_POD`` and ``mesh_config``
    equal the reference's; the device meshes are built over CUDA devices
    in row-major order and raise a ``ValueError`` naming the count on a
    host with too few; ``with mesh:`` sets the ambient mesh."""
    assert dataclasses.asdict(MeshConfig()) == \
        dataclasses.asdict(jbase.MeshConfig())
    for got, want in ((SINGLE_POD, jbase.SINGLE_POD),
                      (MULTI_POD, jbase.MULTI_POD)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.n_devices == want.n_devices
    for multi in (False, True):
        assert tmesh.mesh_config(multi) == \
            (MULTI_POD if multi else SINGLE_POD)
        assert dataclasses.asdict(tmesh.mesh_config(multi)) == \
            dataclasses.asdict(jmesh.mesh_config(multi))
    monkeypatch.setattr(tmesh.torch.cuda, "device_count", lambda: 0)
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} CUDA devices; 0"):
            tmesh.make_production_mesh(multi_pod=multi)
    monkeypatch.setattr(tmesh.torch.cuda, "device_count", lambda: 8)
    m = tmesh.make_mesh(MeshConfig((2, 2, 2), ("pod", "data", "model")))
    assert m.axis_names == ("pod", "data", "model") and m.shape == (2, 2, 2)
    assert [str(d) for d in m.devices.reshape(-1)] == \
        [f"cuda:{i}" for i in range(8)]
    assert rules.data_axes(m) == ("pod", "data")
    assert rules._axis_size(m, rules.data_axes(m)) == 4
    assert ambient_mesh() is None
    a = AbstractMesh((4, 2), ("data", "model"))
    with a:
        assert ambient_mesh() is a
        with m:
            assert ambient_mesh() is m
        assert ambient_mesh() is a
    assert ambient_mesh() is None


# ------------------------------------------------------ local MoE dispatch
def _moe_pair(arch, capacity_factor=None, B=4, S=16):
    """(reference cfg, port cfg, reference layer-0 MoE params, port's, x as
    a numpy array), float32 compute."""
    kw = {"compute_dtype": "float32"}
    jcfg, cfg = jget_tiny(arch).replace(**kw), get_tiny(arch).replace(**kw)
    if capacity_factor is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    jp = jmlp.moe_init(jax.random.PRNGKey(3), jcfg)
    p = state_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    x = np.random.default_rng(4).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, p, x


def _same(got, jgot):
    (y, aux), (jy, jaux) = got, jgot
    jy = np.asarray(jy)
    assert tuple(y.shape) == jy.shape
    assert float(np.abs(y.numpy() - jy).max()) <= \
        Y_REL * float(np.abs(jy).max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)


def _dropped(p, x: torch.Tensor, cfg, g: int) -> int:
    """Top-k assignments past their expert's capacity, over g groups."""
    out = 0
    for xt in x.reshape(g, -1, x.shape[-1]):
        tope = mlp._route(p, xt, cfg)[2]
        count = torch.bincount(tope.reshape(-1), minlength=cfg.moe.n_experts)
        out += int((count - mlp._capacity(xt.shape[0], cfg.moe)).clamp(
            min=0).sum())
    return out


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("g", (1, 2, 4))
def test_moe_apply_local_matches_reference(arch, g):
    """``_moe_apply_local`` over g data groups against the reference's on
    an ``AbstractMesh((g, 1))``, at the config's capacity factor, at 0.5
    (where capacities drop tokens) and at 64 (where none drops). Each group
    has its own capacity: at g = 1 the result is the global dispatch's;
    for g > 1 it differs from the global dispatch where the groups drop
    other tokens than the whole batch does, and equals it where nothing
    drops."""
    jm, m = JAbstractMesh((g, 1), ("data", "model")), \
        AbstractMesh((g, 1), ("data", "model"))
    for factor in (None, 0.5, 64.0):
        jcfg, cfg, jp, p, x = _moe_pair(arch, capacity_factor=factor)
        xt = torch.from_numpy(x)
        local = mlp._moe_apply_local(p, xt, cfg, m, "data")
        _same(local, jmoe_local(jp, jnp.asarray(x), jcfg, jm, "data"))
        glob = mlp.moe_apply(p, xt, cfg)
        gap = float((local[0] - glob[0]).abs().max())
        drops = (_dropped(p, xt, cfg, g), _dropped(p, xt, cfg, 1))
        if factor == 0.5:
            assert drops[1] > 0
        if g == 1:
            assert torch.equal(local[0], glob[0])
        elif drops[0] != drops[1]:
            assert gap > Y_REL * float(glob[0].abs().max()), drops
        if drops == (0, 0):
            assert gap <= Y_REL * float(glob[0].abs().max())
    assert factor == 64.0 and drops == (0, 0)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_under_shard_hints(arch):
    """With an ambient (1,1) mesh (the reference under ``jax.make_mesh``
    with ``Auto`` axes), ``moe_apply`` under ``shard_hints`` equals each
    package's global path. Under an ambient (2,1) mesh the port takes the two-group path;
    a batch the data axes do not divide takes the global one."""
    jcfg, cfg, jp, p, x = _moe_pair(arch)
    hcfg, jhcfg = cfg.replace(shard_hints=True), jcfg.replace(
        shard_hints=True)
    xt = torch.from_numpy(x)
    glob = mlp.moe_apply(p, xt, cfg)
    jglob = jmoe_global(jp, jnp.asarray(x), jcfg)
    with _auto_mesh((1, 1)):
        jgot = jmoe_apply(jp, jnp.asarray(x), jhcfg)
    with DomainMesh.of([[CPU]]):
        got = mlp.moe_apply(p, xt, hcfg)
    assert torch.equal(got[0], glob[0]) and torch.equal(got[1], glob[1])
    np.testing.assert_array_equal(np.asarray(jgot[0]), np.asarray(jglob[0]))
    _same(got, jgot)
    two = AbstractMesh((2, 1), ("data", "model"))
    with two:
        got = mlp.moe_apply(p, xt, hcfg)
        odd = mlp.moe_apply(p, xt[:3], hcfg)
    want = mlp._moe_apply_local(p, xt, cfg, two, "data")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(odd[0], mlp.moe_apply(p, xt[:3], cfg)[0])


# -------------------------------------------------------------- train step
def test_train_step_under_shard_hints_equals_reference():
    """Tiny llama3-8b in float32: the train step under ``shard_hints``
    with an ambient mesh equals the port's step under ``shard_hints``
    without one bit for bit (the reference's layout hints and
    ``_constrain_like_params`` have no counterpart), and both the plain
    step (``shard_hints`` selects the sharded cross-entropy, which rounds
    otherwise) and the reference's under a (1, 1) ``Auto`` mesh at
    ``tests/test_torch_train.py``'s tolerances."""
    kw = {"compute_dtype": "float32"}
    jcfg = jget_tiny("llama3-8b").replace(shard_hints=True, **kw)
    cfg = get_tiny("llama3-8b").replace(**kw)
    tcfg = TrainConfig(remat="none")
    js = jinit_train_state(jax.random.PRNGKey(0), jcfg,
                           jbase.TrainConfig(remat="none"))
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 17))
    jb = {"tokens": jnp.asarray(tokens[:, :-1], jnp.int32),
          "labels": jnp.asarray(tokens[:, 1:], jnp.int32)}
    b = {"tokens": torch.from_numpy(tokens[:, :-1]),
         "labels": torch.from_numpy(tokens[:, 1:])}
    with _auto_mesh((1, 1)):
        jnew, jm = jax.jit(jmake_train_step(
            jcfg, jbase.TrainConfig(remat="none")))(js, jb)

    def port_step(c, mesh):
        s = state_from_numpy(jax.tree.map(np.asarray, js), device=CPU)
        if mesh is None:
            return make_train_step(c, tcfg)(s, b)
        with mesh:
            return make_train_step(c, tcfg)(s, b)
    hcfg = cfg.replace(shard_hints=True)
    new, m = port_step(hcfg, AbstractMesh((1, 1), ("data", "model")))
    alone, am = port_step(hcfg, None)
    plain, pm = port_step(cfg, None)
    assert float(m["loss"]) == float(am["loss"])
    assert all(torch.equal(a, c) for a, c in
               zip(tree.leaves(new), tree.leaves(alone)))
    np.testing.assert_allclose(float(m["loss"]), float(pm["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    got = dict(tree.flatten_with_path(new)[0])
    for want in (dict(_jflat(jnew)), dict(tree.flatten_with_path(plain)[0])):
        assert list(want) == list(got)
        for k, w in want.items():
            w, g = np.asarray(w, np.float64), got[k].double().numpy()
            if k[0] == "params":
                assert np.abs(g - w).max() <= tcfg.lr / 10, k
            else:
                assert np.abs(g - w).max() <= \
                    1e-4 * np.abs(w).max() + 1e-12, k

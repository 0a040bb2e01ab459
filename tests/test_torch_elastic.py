"""Elastic resharding of the port (``runtime.elastic``) and the store's
placed load, against the JAX reference on the CPU.

* ``state_shardings`` gives the reference's specs leaf for leaf for all 12
  configs at their full size (the port's ``meta`` train state, the
  reference's ``jax.eval_shape``), the error-feedback state ``ef`` of
  ``grad_compress`` included, on ``AbstractMesh`` (2,4), (4,2), SINGLE_POD
  and MULTI_POD. The reference runs on its own ``AbstractMesh``: jax 0.9's
  ``make_mesh`` makes ``Explicit`` axes, under which its reshard raises,
  which is why the reference's ``test_elastic_reshard_between_meshes``
  fails on this tree.
* The reshard drill (``repro_torch.examples.elastic_reshard``) on 8 CPU
  gloo ranks in subprocesses: tiny llama3-8b in float32 compute from a
  numpy-seeded state, placed on a (2,4) mesh, one relowered step,
  resharded onto (4,2), another step. Both losses equal the unsharded
  port's within rtol 1e-5 and its parameters within lr/10 (the drill's
  bounds, ``LOSS_RTOL`` and ``PARAM_ATOL``: the ranks sum float32 in other
  orders), the losses equal the reference's unsharded ``make_train_step``
  on the same numpy state within rtol 1e-5 (``tests/test_torch_train.py``'s
  bound for one step), and every rank's local block is the slice the
  rules give its mesh coordinate, the batch on a (2,2,2) pod mesh
  included.
* On one rank (a world-size-1 gloo group, a (1,1) mesh): a relowered step
  equals the unsharded step bit for bit (on one CPU thread: the
  embedding gradient's accumulating ``index_put_`` adds in thread order),
  and ``CheckpointStore.load(
  shardings=)`` falls back past a struck snapshot as the reference's
  ``load`` does and places the restored leaves on the mesh.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.checkpoint.store import CheckpointStore as JCheckpointStore
from repro.configs import get_config as jget_config
from repro.configs import get_tiny as jget_tiny
from repro.configs.base import TrainConfig as JTrainConfig
from repro.runtime import elastic as jelastic
from repro.runtime.steps import init_train_state as jinit_train_state
from repro.runtime.steps import make_train_step as jmake_train_step
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import TrainConfig, list_archs
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy
from repro_torch.core import tree
from repro_torch.examples import elastic_reshard as drill
from repro_torch.launch.specs import train_state_shape
from repro_torch.runtime import elastic
from repro_torch.runtime.steps import make_train_step
from repro_torch.sharding.mesh import AbstractMesh

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = (((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))


@pytest.mark.parametrize("arch", list_archs())
def test_state_shardings_equal_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jst = jax.eval_shape(lambda: jinit_train_state(
        jax.random.PRNGKey(0), jcfg, JTrainConfig(grad_compress=True)))
    st = train_state_shape(cfg, TrainConfig(grad_compress=True))
    assert sorted(st) == ["ef", "opt", "params"]
    for shape, axes in MESHES:
        want = jelastic.state_shardings(jst, JAbstractMesh(shape, axes),
                                        jcfg)
        got = elastic.state_shardings(st, AbstractMesh(shape, axes), cfg)
        wl = jax.tree_util.tree_flatten_with_path(want)[0]
        gl = tree.flatten_with_path(got)[0]
        assert [tuple(str(getattr(e, "key", e)) for e in p) for p, _ in wl] \
            == [p for p, _ in gl]
        assert [tuple(s.spec) for _, s in gl] == \
            [tuple(s.spec) for _, s in wl], (arch, shape)


def _reference_losses(n_steps: int) -> list:
    jcfg = jget_tiny(drill.ARCH).replace(compute_dtype="float32")
    ns = drill.numpy_state(drill.drill_config())
    js = jax.tree.map(jnp.asarray, ns)
    jb = {k: jnp.asarray(v, jnp.int32)
          for k, v in drill.numpy_batch(drill.drill_config()).items()}
    step = jax.jit(jmake_train_step(jcfg, JTrainConfig(remat="none")))
    out = []
    for _ in range(n_steps):
        js, m = step(js, jb)
        out.append(float(m["loss"]))
    return out


def test_reshard_drill_on_eight_gloo_ranks(tmp_path):
    out = tmp_path / "drill.npz"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.elastic_reshard",
         "--ranks", "8", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.splitlines()[-1] == "ELASTIC OK"
    with np.load(out) as z:
        res = {k: z[k] for k in z.files}
    assert int(res["mismatches"]) == 0
    np.testing.assert_allclose(res["losses"], res["plain_losses"],
                               rtol=drill.LOSS_RTOL)
    params = [k[len("params/"):] for k in res if k.startswith("params/")]
    assert len(params) == len(tree.leaves(
        train_state_shape(drill.drill_config(), drill.TCFG)["params"]))
    for k in params:
        assert np.abs(res["params/" + k] - res["plain/" + k]).max() \
            <= drill.PARAM_ATOL, k
    np.testing.assert_allclose(res["losses"], _reference_losses(2),
                               rtol=1e-5)


@pytest.fixture
def one_rank_mesh(tmp_path):
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _same_bits(a, b) -> bool:
    from torch.distributed.tensor import DTensor

    def local(t):
        t = t.to_local() if isinstance(t, DTensor) else t
        return t.contiguous().reshape(-1).view(torch.uint8)
    fa, fb = tree.flatten_with_path(a), tree.flatten_with_path(b)
    return fa[1] == fb[1] and all(
        torch.equal(local(x), local(y)) for (_, x), (_, y) in zip(fa[0], fb[0]))


@pytest.fixture
def one_thread():
    """The CPU's accumulating ``index_put_`` (the embedding gradient) adds
    in thread order: one thread makes a step repeat bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_relowered_step_on_one_rank_equals_unsharded(one_rank_mesh,
                                                      one_thread):
    cfg = drill.drill_config()
    state = state_from_numpy(drill.numpy_state(cfg), device="cpu")
    batch = state_from_numpy(drill.numpy_batch(cfg), device="cpu")
    step = make_train_step(cfg, drill.TCFG)
    want, wm = step(state, batch)
    placed = elastic.reshard_state(state, one_rank_mesh, cfg)
    run = elastic.relower_train_step(step, placed, batch, one_rank_mesh, cfg)
    got, m = run(placed, batch)
    assert _same_bits(got, want)
    assert float(m["loss"]) == float(wm["loss"])
    assert not isinstance(m["loss"], torch.distributed.tensor.DTensor)


def test_store_load_with_shardings_falls_back_and_places(one_rank_mesh,
                                                         tmp_path):
    from torch.distributed.tensor import DTensor
    cfg = drill.drill_config()
    s1 = state_from_numpy(drill.numpy_state(cfg), device="cpu")
    s2, _ = make_train_step(cfg, drill.TCFG)(
        s1, state_from_numpy(drill.numpy_batch(cfg), device="cpu"))
    store = CheckpointStore(tmp_path / "ck", device="cpu")
    store.save(1, s1)
    store.save(2, s2)
    data = tmp_path / "ck" / "step_00000002" / "data.npz"
    raw = bytearray(data.read_bytes())
    raw[len(raw) // 2] ^= 0x40
    data.write_bytes(bytes(raw))
    sh = elastic.state_shardings(s1, one_rank_mesh, cfg)
    got = store.load(2, s1, shardings=sh)
    assert store.last_loaded_step == 1
    leaves = tree.leaves(got)
    assert all(isinstance(t, DTensor) and t.device_mesh == one_rank_mesh
               for t in leaves)
    assert _same_bits(got, s1)
    jstore = JCheckpointStore(tmp_path / "ck")
    jgot = jstore.load(2, jax.tree.map(np.asarray, tree.map_leaves(
        lambda t: t.numpy(), s1)))
    assert jstore.last_loaded_step == 1
    for (_, j), t in zip(jax.tree_util.tree_flatten_with_path(jgot)[0],
                         leaves):
        np.testing.assert_array_equal(np.asarray(j), t.to_local().numpy())


def test_ops_dtensor_refuses_run_gathered(one_rank_mesh):
    """Under ``on_mesh()`` an op with no sharding strategy runs on the
    whole tensors (``searchsorted``), and an in-place one writes into the
    whole target, each rank keeping its block (``put_``)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = one_rank_mesh
    x = torch.arange(16.0).reshape(4, 4)
    idx, v = torch.tensor([1, 6, 13]), torch.tensor([-1.0, -2.0, -3.0])
    dx = distribute_tensor(x.clone(), mesh, [Shard(0), Shard(1)])
    with elastic.on_mesh():
        dx.put_(distribute_tensor(idx, mesh, [Replicate()] * 2),
                distribute_tensor(v, mesh, [Replicate()] * 2))
        got = torch.searchsorted(
            distribute_tensor(torch.arange(8.0), mesh, [Shard(0),
                                                        Replicate()]),
            distribute_tensor(torch.tensor([2.5, 7.0]), mesh,
                              [Replicate()] * 2))
    assert torch.equal(dx.full_tensor(), x.clone().put_(idx, v))
    assert torch.equal(got.full_tensor(),
                       torch.searchsorted(torch.arange(8.0),
                                          torch.tensor([2.5, 7.0])))

"""Elastic resize drill: train on one mesh of ranks, lose the mesh's shape,
reshard the live state onto a mesh of another shape, and train on.

The scenario of the reference's ``tests/test_elastic.py`` on the port's
``runtime.elastic``, held to values. Each of ``--ranks`` processes joins
one ``torch.distributed`` group (gloo on the CPU, NCCL on cards, one card
a rank) and runs ``drill``: a tiny config's float32 train state, made from
a numpy seed, is placed on a ``(2, n/2)`` ``(data, model)`` mesh
(``reshard_state``), takes one relowered step, is resharded onto an
``(n/2, 2)`` mesh and takes another. Each rank checks that every local
block it holds is the slice that ``sharding.rules`` gives its mesh
coordinate; with 8 ranks it also places the batch on a ``(2, 2, 2)``
``(pod, data, model)`` mesh, whose batch spec splits one dim over two
axes. Rank 0 runs the same two steps unsharded and reports both.

Run: ``python -m repro_torch.examples.elastic_reshard --ranks 8 --device
cpu`` (8 gloo processes), or on N cards ``--ranks N``.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import TrainConfig, get_tiny
from repro_torch.core import tree
from repro_torch.sharding import rules
from repro_torch.sharding.mesh import AbstractMesh

ARCH = "llama3-8b"
BATCH, SEQ = 8, 64
TCFG = TrainConfig(remat="none")
# sharded against unsharded, float32: the ranks sum in other orders. An
# AdamW step moves a parameter by about lr, so a parameter bound of lr / 10
# (as tests/test_torch_train.py holds a step to the reference) still reads
# a wrong update.
LOSS_RTOL = 1e-5
PARAM_ATOL = TCFG.lr / 10


def drill_config():
    return get_tiny(ARCH).replace(compute_dtype="float32")


def numpy_state(cfg, seed: int = 0):
    """A train state of ``cfg`` as numpy arrays from ``seed``: parameters
    N(0, 0.02) (norm scales 1), zero moments, count 0; the same arrays go
    into either package."""
    from repro_torch.launch.specs import train_state_shape
    rng = np.random.default_rng(seed)

    def leaf(path, t):
        shape = tuple(t.shape)
        if path[0] != "params":
            return np.zeros(shape, np.int32 if path[-1] == "count"
                            else np.float32)
        if "norm" in path[-1]:
            return np.ones(shape, np.float32)
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)
    return tree.map_with_path(leaf, train_state_shape(cfg, TCFG))


def numpy_batch(cfg, seed: int = 1):
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                             (BATCH, SEQ + 1))
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def meshes(n: int):
    """The drill's two ``(data, model)`` mesh shapes for ``n`` ranks."""
    if n < 2 or n % 2:
        raise ValueError(f"the drill needs an even number of ranks, not {n}")
    return (2, n // 2), (n // 2, 2)


def _expected_block(full: torch.Tensor, sharding, coord) -> torch.Tensor:
    """The block of ``full`` that ``sharding`` gives the mesh coordinate
    ``coord`` (one index a mesh axis): each split dim takes the shard whose
    index counts over its axes major to minor, as ``jax.sharding``
    does."""
    mesh = sharding.mesh
    at = dict(zip(mesh.axis_names, coord))
    size = dict(zip(mesh.axis_names, mesh.axis_sizes))
    block = sharding.shard_shape(tuple(full.shape))
    idx = []
    for d, n in enumerate(block):
        entry = sharding.spec[d] if d < len(sharding.spec) else None
        axes = () if entry is None else \
            (entry if isinstance(entry, tuple) else (entry,))
        i = 0
        for a in axes:
            i = i * size[a] + at[a]
        idx.append(slice(i * n, (i + 1) * n))
    return full[tuple(idx)]


def _block_mismatches(placed, shardings, device_mesh) -> int:
    """Leaves of ``placed`` (DTensors on ``device_mesh``) whose local block
    is not the slice of the whole leaf that ``shardings`` (the rules' specs
    on the same axes) give this rank's mesh coordinate."""
    coord = device_mesh.get_coordinate()
    return sum(not torch.equal(leaf.to_local(), _expected_block(
                   leaf.full_tensor(), sh, coord))
               for leaf, sh in zip(tree.leaves(placed),
                                   tree.leaves(shardings)))


def drill(rank: int, world: int, init_file: str, device: str, out: str
          ) -> None:
    """One rank of the drill; rank 0 saves the results to ``out``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.convert import state_from_numpy
    from repro_torch.runtime.elastic import (place_tree, relower_train_step,
                                             reshard_state, state_shardings)
    from repro_torch.runtime.steps import make_train_step
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        cfg = drill_config()
        state = state_from_numpy(numpy_state(cfg), device=dev)
        batch = state_from_numpy(numpy_batch(cfg), device=dev)
        step = make_train_step(cfg, TCFG)
        losses, mismatches = [], 0
        for shape in meshes(world):
            mesh = init_device_mesh(dev.type, shape,
                                    mesh_dim_names=("data", "model"))
            state = reshard_state(state, mesh, cfg)
            run = relower_train_step(step, state, batch, mesh, cfg)
            state, metrics = run(state, batch)
            losses.append(float(metrics["loss"]))
            mismatches += _block_mismatches(
                state, state_shardings(state, AbstractMesh.of(mesh), cfg),
                mesh)
        if world == 8:
            pod = init_device_mesh(dev.type, (2, 2, 2),
                                   mesh_dim_names=("pod", "data", "model"))
            b_sh = rules.batch_shardings(batch, AbstractMesh.of(pod))
            placed = place_tree(batch, tree.map_leaves(
                lambda s: rules.NamedSharding(pod, s.spec), b_sh))
            mismatches += _block_mismatches(placed, b_sh, pod)
        bad = torch.tensor([mismatches], device=dev)
        dist.all_reduce(bad)
        mismatches = int(bad.item())
        params = {k: v.full_tensor().cpu().numpy() for k, v in
                  _flat(state["params"]).items()}
        if rank == 0:
            plain = state_from_numpy(numpy_state(cfg), device=dev)
            plain_losses = []
            for _ in meshes(world):
                plain, m = step(plain, batch)
                plain_losses.append(float(m["loss"]))
            np.savez(out, losses=np.array(losses),
                     plain_losses=np.array(plain_losses),
                     mismatches=np.array(mismatches),
                     **{"params/" + k: v for k, v in params.items()},
                     **{"plain/" + k: v.cpu().numpy() for k, v in
                        _flat(plain["params"]).items()})
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _flat(t):
    return {"/".join(p): x for p, x in tree.flatten_with_path(t)[0]}


def run(ranks: int, device: str, out: str) -> dict:
    """Runs the drill on ``ranks`` processes and returns rank 0's results:
    ``losses`` (sharded), ``plain_losses``, ``mismatches`` (blocks not
    where the rules put them), and the parameters after the last step,
    ``params/<path>`` and ``plain/<path>``."""
    import torch.multiprocessing as mp
    meshes(ranks)
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "init")
        mp.start_processes(drill, args=(ranks, init_file, device, out),
                           nprocs=ranks, join=True, start_method="spawn")
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cpu for gloo processes; the cards otherwise")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = args.device or "cuda"
    if device == "cuda" and torch.cuda.device_count() < args.ranks:
        raise RuntimeError(f"{args.ranks} ranks need {args.ranks} CUDA "
                           f"devices; {torch.cuda.device_count()} visible "
                           "(pass --device cpu for gloo processes)")
    with tempfile.TemporaryDirectory() as tmp:
        res = run(args.ranks, device,
                  args.out or str(Path(tmp) / "elastic.npz"))
    params = [k[len("params/"):] for k in res if k.startswith("params/")]
    dmax = max(float(np.abs(res["params/" + k] - res["plain/" + k]).max())
               for k in params)
    print(f"losses sharded={res['losses'].tolist()} "
          f"unsharded={res['plain_losses'].tolist()}")
    print(f"params max |sharded - unsharded|={dmax:.3e} "
          f"misplaced_blocks={int(res['mismatches'])}")
    if int(res["mismatches"]) or dmax > PARAM_ATOL or not np.allclose(
            res["losses"], res["plain_losses"], rtol=LOSS_RTOL, atol=0):
        raise AssertionError("the sharded drill left the unsharded run")
    print("ELASTIC OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

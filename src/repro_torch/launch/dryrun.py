"""Multi-pod dry-run: prove that every (arch x shape x mesh) cell places
and runs on a production mesh, and record its roofline inputs.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell on 256 or 512 host devices that XLA fakes. Here the mesh is a
``torch.distributed`` ``DeviceMesh`` in ``SINGLE_POD``'s or
``MULTI_POD``'s layout over a fake process group of 256 or 512 ranks
(``torch.testing``'s ``fake`` backend: collectives are accepted and move
nothing). This process is rank 0. Every input leaf is a DTensor built
with ``DTensor.from_local`` from a ``meta`` tensor of its per-device shape
(``sharding.rules``' ``NamedSharding.shard_shape``), so nothing is
allocated and building the inputs needs no collective. The step runs
under ``runtime.elastic.on_mesh()`` (``implicit_replication()`` and
GSPMD's layouts where DTensor refuses one) and ``launch.step_cost``,
which counts the FLOPs, bytes and collectives of one device.

The record has the reference's keys. ``memory`` holds the per-device bytes
of the arguments and outputs; XLA's ``temp_size_in_bytes`` (the compiled
program's scratch) has no counterpart on ``meta`` tensors, which hold no
memory, and is None. A cell that raises is recorded as ``status:
"error"`` and the run goes on.

Usage (host only, no card):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k --multi-pod
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPE_BY_NAME, SHAPES,
                                 get_config, shape_applicability)
from repro_torch.configs.base import MeshConfig, ModelConfig, ShapeSpec
from repro_torch.core import tree
from repro_torch.launch import specs as S
from repro_torch.launch import step_cost
from repro_torch.launch.mesh import mesh_config
from repro_torch.launch.modelbytes import analytic_bytes
from repro_torch.launch.modelflops import model_flops
from repro_torch.runtime import elastic
from repro_torch.runtime.steps import (make_prefill_step, make_serve_step,
                                       make_train_step)
from repro_torch.sharding import rules
from repro_torch.sharding.mesh import AbstractMesh

DEFAULT_OUT = "results/dryrun_torch.json"


def fake_device_mesh(mesh_cfg: MeshConfig):
    """A ``DeviceMesh`` of ``mesh_cfg``'s shape and axes over a fake process
    group of its device count, this process rank 0. A fake group of
    another size is replaced; a real one raises, as it is not ours."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = mesh_cfg.n_devices
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a process group is already initialised; the "
                               "dry-run needs its own fake one")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return init_device_mesh("cpu", tuple(mesh_cfg.shape),
                            mesh_dim_names=tuple(mesh_cfg.axes))


def place_meta(tree_, shardings, device_mesh):
    """``tree_``'s leaves as DTensors over ``device_mesh`` whose local
    tensors are ``meta`` tensors of each leaf's per-device shape."""
    from torch.distributed.tensor import DTensor

    def one(leaf, sh):
        local = torch.empty(sh.shard_shape(tuple(leaf.shape)),
                            dtype=leaf.dtype, device="meta")
        return DTensor.from_local(
            local, device_mesh, rules.placements(sh, device_mesh),
            run_check=False, shape=leaf.shape, stride=leaf.stride())
    flat, treedef = tree.flatten_with_path(tree_)
    return tree.unflatten(treedef, [
        one(leaf, sh) for (_, leaf), sh in zip(flat, tree.leaves(shardings))])


def _local_bytes(x) -> int:
    """Bytes of one device's share of the tensors in ``x`` (nested
    tuples, lists and dicts)."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, (list, tuple)):
        return sum(_local_bytes(y) for y in x)
    if isinstance(x, dict):
        return sum(_local_bytes(y) for y in x.values())
    if isinstance(x, DTensor):
        x = x.to_local()
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


def run_cell(cfg: ModelConfig, shape: ShapeSpec, mesh_cfg: MeshConfig, *,
             seq_shard_cache: bool = False, tcfg_override=None,
             shard_hints: bool = False) -> dict:
    """Place and run one cell of ``cfg`` x ``shape`` on a fake mesh of
    ``mesh_cfg``; returns its record (without ``arch``/``shape``/``mesh``)."""
    if shard_hints:
        cfg = cfg.replace(shard_hints=True)
    mesh = AbstractMesh(tuple(mesh_cfg.shape), tuple(mesh_cfg.axes))
    n_dev = mesh_cfg.n_devices
    rec = {"n_devices": n_dev}
    t0 = time.perf_counter()
    dmesh = fake_device_mesh(mesh_cfg)
    tc = None
    if shape.kind == "train":
        tc = tcfg_override or S.default_train_config(cfg, shape)
        # per-microbatch batch must stay shardable over the data axes
        dp_size = rules._axis_size(mesh, rules.data_axes(mesh))
        max_mb = max(1, shape.global_batch // dp_size)
        tcfg = dataclasses.replace(tc, microbatches=min(tc.microbatches,
                                                        max_mb))
        rec["tcfg"] = {"microbatches": tcfg.microbatches,
                       "remat": tcfg.remat,
                       "grad_compress": tcfg.grad_compress}
        state_shape = S.train_state_shape(cfg, tcfg)
        batch_shape = S.batch_specs(cfg, shape)
        args = (place_meta(state_shape, elastic.state_shardings(
                    state_shape, mesh, cfg), dmesh),
                place_meta(batch_shape, rules.batch_shardings(
                    batch_shape, mesh), dmesh))
        step = elastic.relower_train_step(make_train_step(cfg, tcfg),
                                          state_shape, batch_shape, dmesh,
                                          cfg)
    elif shape.kind == "prefill":
        params_shape = S.params_shape(cfg)
        batch_shape = S.batch_specs(cfg, shape)
        args = (place_meta(params_shape, rules.param_shardings(
                    params_shape, mesh, cfg), dmesh),
                place_meta(batch_shape, rules.batch_shardings(
                    batch_shape, mesh), dmesh))
        prefill = make_prefill_step(cfg)

        def step(params, batch):
            with elastic.on_mesh():
                return prefill(params, batch)
    else:  # decode
        params_shape = S.params_shape(cfg)
        # serving layout: TP-only weights (no FSDP gathers) whenever the
        # model-sharded params fit HBM (see rules.param_spec)
        p_bytes = sum(math.prod(leaf.shape) * leaf.element_size()
                      for leaf in tree.leaves(params_shape))
        tp_only = shard_hints and p_bytes / 16 <= 12e9
        rec["tp_only"] = tp_only
        cache_shape, tok, pos = S.decode_specs(cfg, shape)
        args = (place_meta(params_shape, rules.param_shardings(
                    params_shape, mesh, cfg, tp_only=tp_only), dmesh),
                place_meta(cache_shape, rules.cache_shardings(
                    cache_shape, mesh, cfg, seq_shard_cache), dmesh),
                place_meta({"t": tok}, rules.batch_shardings(
                    {"t": tok}, mesh), dmesh)["t"], pos)
        serve = make_serve_step(cfg)

        def step(params, cache, token, pos):
            with elastic.on_mesh():
                return serve(params, cache, token, pos)
    rec["memory"] = {"argument_size_in_bytes": _local_bytes(args)}
    with step_cost.counting() as cost:
        out = step(*args)
    rec["memory"].update(output_size_in_bytes=_local_bytes(out),
                         temp_size_in_bytes=None)
    rec["run_s"] = round(time.perf_counter() - t0, 2)
    rec["hlo"] = cost.to_dict()
    rec["roofline"] = step_cost.roofline(cost, n_dev).to_dict()
    rec["model_flops_global"] = model_flops(cfg, shape)
    rec["analytic_bytes_per_device"] = analytic_bytes(cfg, shape, n_dev, tc)
    rec["status"] = "ok"
    return rec


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               seq_shard_cache: bool = False, tcfg_override=None,
               shard_hints: bool = False) -> dict:
    """Place and run one registry cell at its full size; returns its
    record."""
    cfg = get_config(arch)
    shape = SHAPE_BY_NAME[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "multi_pod_2x16x16" if multi_pod else "single_pod_16x16",
           "seq_shard_cache": seq_shard_cache, "shard_hints": shard_hints}
    skip = shape_applicability(cfg, shape)
    if skip:
        rec.update(status="skip", reason=skip)
        return rec
    rec.update(run_cell(cfg, shape, mesh_config(multi_pod),
                        seq_shard_cache=seq_shard_cache,
                        tcfg_override=tcfg_override,
                        shard_hints=shard_hints))
    return rec


def run_cells(cells, out_path: Path, *, force=False, seq_shard=False,
              shard_hints=False):
    results = {}
    if out_path.exists():
        results = json.loads(out_path.read_text())
    for arch, shape_name, multi_pod in cells:
        key = f"{arch}|{shape_name}|{'multi' if multi_pod else 'single'}"
        if seq_shard:
            key += "|seqshard"
        if shard_hints:
            key += "|hints"
        if key in results and results[key].get("status") in ("ok", "skip") \
                and not force:
            print(f"[cached] {key}: {results[key]['status']}")
            continue
        print(f"[dryrun] {key} ...", flush=True)
        try:
            rec = lower_cell(arch, shape_name, multi_pod=multi_pod,
                             seq_shard_cache=seq_shard,
                             shard_hints=shard_hints)
            if rec["status"] == "ok":
                print(f"  OK run={rec['run_s']}s "
                      f"flops/dev={rec['hlo']['flops']:.3e} "
                      f"coll_link={rec['hlo']['total_coll_link_bytes']:.3e}")
            else:
                print(f"  SKIP: {rec['reason']}")
        except Exception as e:  # noqa: BLE001 — record and continue
            rec = {"arch": arch, "shape": shape_name,
                   "mesh": "multi" if multi_pod else "single",
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
            print(f"  ERROR {type(e).__name__}: {e}")
        results[key] = rec
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(results, indent=1, default=float))
    return results


def all_cells(meshes=("single", "multi")):
    cells = []
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES:
            for m in meshes:
                cells.append((arch, shape.name, m == "multi"))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--seq-shard-cache", action="store_true")
    ap.add_argument("--shard-hints", action="store_true",
                    help="run the shard_hints variant; recorded under a "
                         "separate |hints key")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    if args.all:
        meshes = []
        if args.single_pod or not args.multi_pod:
            meshes.append("single")
        if args.multi_pod or not args.single_pod:
            meshes.append("multi")
        cells = all_cells(tuple(meshes))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape, args.multi_pod)]
    run_cells(cells, Path(args.out), force=args.force,
              seq_shard=args.seq_shard_cache, shard_hints=args.shard_hints)


if __name__ == "__main__":
    main()

"""Device meshes: the sharding rules' meshes and sharded memory domains'
grids.

Counterpart of ``repro.launch.mesh`` and of ``_mesh_devices`` in
``repro.core.sharded``. A ``DomainMesh`` is a grid of ``torch.device``s
with named axes: for a sharded memory domain, ``data`` carries the
data-parallel replicas (the ``PEER_COPY`` donors) and ``model`` the leaf
shards; ``core.sharded.ShardedMemoryDomain.protect(mesh=...)`` places each
(replica, shard) cell's leaves on its grid device. ``make_mesh`` and
``make_production_mesh`` build one over CUDA devices in a ``MeshConfig``'s
layout. ``with mesh:`` makes a ``DomainMesh`` the thread's ambient mesh
(``sharding.mesh``).

A hand-built mesh may name one device more than once: torch has a single
``cpu`` device, so the CPU tests build their grids that way, where the
reference forces several host devices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.base import MULTI_POD, SINGLE_POD, MeshConfig
from repro_torch.sharding.mesh import _Ambient

@dataclass(frozen=True, eq=False)
class DomainMesh(_Ambient):
    """``devices``: an object array of ``torch.device`` with one axis per
    name of ``axis_names``."""
    devices: np.ndarray
    axis_names: Tuple[str, ...] = ("data", "model")

    def __post_init__(self):
        if np.asarray(self.devices).ndim != len(self.axis_names):
            raise ValueError(f"a {np.asarray(self.devices).ndim}-d device "
                             f"grid for axes {self.axis_names}")

    @classmethod
    def of(cls, grid, axis_names: Tuple[str, ...] = ("data", "model")
           ) -> "DomainMesh":
        """A mesh over ``grid``: nested lists of devices or device names."""
        rows = np.asarray(grid, dtype=object)
        out = np.empty(rows.shape, dtype=object)
        for idx in np.ndindex(rows.shape):
            out[idx] = torch.device(rows[idx])
        return cls(out, tuple(axis_names))

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def axis_sizes(self) -> Tuple[int, ...]:
        return self.shape


def _cuda_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
               what: str) -> DomainMesh:
    """A mesh of ``shape`` over the first CUDA devices in row-major order.
    Like ``jax.make_mesh``, it raises when fewer are visible."""
    need = int(np.prod(shape))
    have = torch.cuda.device_count()
    if have < need:
        raise ValueError(f"a {what} needs {need} CUDA devices; {have} "
                         "visible")
    names = np.array([f"cuda:{i}" for i in range(need)],
                     dtype=object).reshape(shape)
    return DomainMesh.of(names.tolist(), axes)


def make_domain_mesh(n_replicas: int = 2, n_shards: int = 2) -> DomainMesh:
    """A ``(data, model)`` mesh over the first ``n_replicas * n_shards``
    CUDA devices, for sharded memory domains."""
    return _cuda_mesh((n_replicas, n_shards), ("data", "model"),
                      f"{n_replicas}x{n_shards} domain mesh")


def make_mesh(mesh_cfg: MeshConfig) -> DomainMesh:
    """A mesh of ``mesh_cfg``'s shape and axes over CUDA devices."""
    return _cuda_mesh(tuple(mesh_cfg.shape), tuple(mesh_cfg.axes),
                      "x".join(map(str, mesh_cfg.shape)) + " mesh")


def make_production_mesh(*, multi_pod: bool = False) -> DomainMesh:
    """SINGLE_POD's 16x16 ``(data, model)`` mesh, or MULTI_POD's 2x16x16
    ``(pod, data, model)``: 256 or 512 CUDA devices."""
    return make_mesh(mesh_config(multi_pod))


def mesh_config(multi_pod: bool) -> MeshConfig:
    return MULTI_POD if multi_pod else SINGLE_POD


def mesh_grid(mesh, replica_axis: str = "data",
              shard_axis: str = "model") -> np.ndarray:
    """``mesh``'s devices as a ``(replicas, shards)`` array: axes other than
    the two collapse onto the first device of each cell."""
    axes = tuple(mesh.axis_names)
    if replica_axis not in axes or shard_axis not in axes:
        raise ValueError(f"mesh axes {axes} lack "
                         f"({replica_axis!r}, {shard_axis!r})")
    dev = np.asarray(mesh.devices, dtype=object)
    dev = np.moveaxis(dev, (axes.index(replica_axis),
                            axes.index(shard_axis)), (0, 1))
    return dev.reshape(dev.shape[0], dev.shape[1], -1)[:, :, 0]

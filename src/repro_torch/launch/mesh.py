"""Device grids for sharded memory domains.

Counterpart of ``make_domain_mesh`` in ``repro.launch.mesh`` and of
``_mesh_devices`` in ``repro.core.sharded``. A ``DomainMesh`` is a grid of
``torch.device``s with named axes: ``data`` carries the data-parallel
replicas (the ``PEER_COPY`` donors) and ``model`` the leaf shards.
``core.sharded.ShardedMemoryDomain.protect(mesh=...)`` places each
(replica, shard) cell's leaves on its grid device.

A hand-built mesh may name one device more than once: torch has a single
``cpu`` device, so the CPU tests build their grids that way, where the
reference forces several host devices.

``make_production_mesh``, ``make_mesh`` and ``mesh_config`` need
``MeshConfig``, which is not ported (ROADMAP.md, queue 1, item 12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True, eq=False)
class DomainMesh:
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


def make_domain_mesh(n_replicas: int = 2, n_shards: int = 2) -> DomainMesh:
    """A ``(data, model)`` mesh over the first ``n_replicas * n_shards``
    CUDA devices. Like ``jax.make_mesh``, it raises when fewer are
    visible."""
    need = n_replicas * n_shards
    have = torch.cuda.device_count()
    if have < need:
        raise ValueError(f"a {n_replicas}x{n_shards} domain mesh needs {need} "
                         f"CUDA devices; {have} visible")
    return DomainMesh.of([[f"cuda:{r * n_shards + s}" for s in range(n_shards)]
                          for r in range(n_replicas)])


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

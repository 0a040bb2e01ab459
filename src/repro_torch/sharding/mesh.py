"""The thread's ambient mesh and the device-free mesh.

``with mesh:`` on any of the port's mesh types (``AbstractMesh`` here,
``launch.mesh.DomainMesh``) makes it the ambient mesh of the thread, as
``with mesh:`` does in the reference; ``ambient_mesh`` returns it.
``AbstractMesh`` is the counterpart of ``jax.sharding.AbstractMesh``:
named axis sizes and no devices, which is all ``sharding.rules`` reads,
so placements at the production meshes' sizes are computed on one card or
none.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Tuple

_AMBIENT = threading.local()


def ambient_mesh():
    """The innermost mesh entered with ``with`` on this thread, or None."""
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


class _Ambient:
    """``with mesh:`` pushes the mesh as the thread's ambient mesh."""

    def __enter__(self):
        if not hasattr(_AMBIENT, "stack"):
            _AMBIENT.stack = []
        _AMBIENT.stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.stack.pop()


@dataclass(frozen=True, eq=False)
class AbstractMesh(_Ambient):
    """Named axis sizes and no devices."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"axis sizes {self.axis_sizes} for axes "
                             f"{self.axis_names}")

    @classmethod
    def of(cls, mesh) -> "AbstractMesh":
        """The axis names and sizes of ``mesh``: a port mesh, or a
        ``torch.distributed`` ``DeviceMesh`` (its ``mesh_dim_names``)."""
        if hasattr(mesh, "mesh_dim_names"):
            return cls(tuple(mesh.shape), tuple(mesh.mesh_dim_names))
        return cls(tuple(mesh.axis_sizes), tuple(mesh.axis_names))

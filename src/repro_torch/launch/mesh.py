"""Device meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` are the JAX package's axis names (``data``, ``model``,
``pod``). :func:`make_mesh` builds one over the default process group, which
the caller starts (``torch.distributed.init_process_group``; at world size 1
with a ``HashStore``, no network port is needed).

The JAX package's ``make_production_mesh`` ((data=16, model=16) = 256 chips,
(pod=2, data=16, model=16) = 512) has no counterpart here: one card cannot
hold it. Importing this module touches no device or process-group state.
"""
from __future__ import annotations

import math
from typing import Sequence

from repro_torch.device import DeviceLike, resolve_device


def make_mesh(shape: Sequence[int], axes: Sequence[str], device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group's ranks, on ``device``'s type (``None``: CUDA)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes the global batch shards over (pod folds into data parallelism)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def all_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, axes) -> int:
    """Ranks along one named axis, or along several together (their product)."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in names)

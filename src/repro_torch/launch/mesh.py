"""Device meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` are the JAX package's axis names (``data``, ``model``,
``pod``). :func:`make_mesh` builds one over the default process group, which
the caller starts (``torch.distributed.init_process_group``; at world size 1
with a ``HashStore``, no network port is needed).

:func:`make_production_mesh` gives the production mesh ((data=16, model=16) =
256 ranks; with ``multi_pod``, (pod=2, data=16, model=16) = 512) over a
default group of that size. The launch tools count on it without cards:
:func:`production_mesh_for_counting` starts a ``fake`` group of that many
ranks (``torch.distributed``'s test backend: collectives return at once and
move nothing), the counterpart of the JAX dry run's 512 forced host devices.
Importing this module touches no device or process-group state.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence

from repro_torch.device import DeviceLike, resolve_device

PRODUCTION_SHAPE = {False: ((16, 16), ("data", "model")),
                    True: ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh(shape: Sequence[int], axes: Sequence[str], device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group's ranks, on ``device``'s type (``None``: CUDA)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None):
    """The production mesh over the default process group, which must have
    256 ranks (512 with ``multi_pod``), on ``device``'s type (``None``: CUDA)."""
    import torch.distributed as dist

    shape, axes = PRODUCTION_SHAPE[multi_pod]
    if not dist.is_initialized() or dist.get_world_size() != math.prod(shape):
        have = dist.get_world_size() if dist.is_initialized() else "no group"
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} needs a default "
                         f"process group of {math.prod(shape)} ranks ({have})")
    return make_mesh(shape, axes, device)


@contextlib.contextmanager
def production_mesh_for_counting(*, multi_pod: bool = False):
    """The production mesh on the CPU for a cost count. Without a default
    process group it starts a ``fake`` one of the mesh's size for the block
    and destroys it after; a live group is never replaced (it must then have
    the mesh's size)."""
    import torch.distributed as dist

    started = not dist.is_initialized()
    if started:
        from torch.testing._internal.distributed.fake_pg import FakeStore

        shape, _ = PRODUCTION_SHAPE[multi_pod]
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=math.prod(shape))
    try:
        yield make_production_mesh(multi_pod=multi_pod, device="cpu")
    finally:
        if started:
            dist.destroy_process_group()


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes the global batch shards over (pod folds into data parallelism)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def all_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, axes) -> int:
    """Ranks along one named axis, or along several together (their product)."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in names)

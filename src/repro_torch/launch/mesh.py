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
move nothing), the counterpart of the JAX dry run's 512 forced host devices;
:func:`counting_mesh` does the same for a mesh of any shape.

A live group of several processes runs the partitioned program
(``models.model.decode_step``/``prefill`` with ``mesh=``): :func:`spawn`
starts one process a rank with the ``spawn`` start method (no inherited CUDA
context), joins them in a ``gloo`` group on a ``file://`` store in a fresh
temporary directory (no network port) and returns what each rank returned.
Each rank then builds its mesh with :func:`make_mesh` and reads its place in
it with :func:`coordinates` / :func:`axis_index`. Importing this module
touches no device or process-group state.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
import shutil
import tempfile
from typing import Any, Callable, Sequence

from repro_torch.device import DeviceLike, resolve_device

PRODUCTION_SHAPE = {False: ((16, 16), ("data", "model")),
                    True: ((2, 16, 16), ("pod", "data", "model"))}
MODEL_SHARD = 16  # `model` mesh-axis size every production mesh uses
SPAWN_TIMEOUT_S = 600   # a spawned group's collectives give up after this


def make_mesh(shape: Sequence[int], axes: Sequence[str], device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group's ranks, on ``device``'s type (``None``: CUDA). Every size must
    divide :data:`MODEL_SHARD`: the sharding rules split a dim over ``model``
    where 16 divides it, so any such size splits it evenly."""
    from torch.distributed.device_mesh import init_device_mesh

    if any(MODEL_SHARD % n for n in shape):
        raise ValueError(f"mesh {dict(zip(axes, shape))}: every axis size must divide "
                         f"{MODEL_SHARD}")
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
def counting_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A mesh of ``shape`` named ``axes`` on the CPU for a count, as rank 0
    sees it. Without a default process group it starts a ``fake`` one of the
    mesh's size for the block (its collectives return at once and move
    nothing, on any device, ``meta`` included) and destroys it after; a live
    group is never replaced: it must then have the mesh's size."""
    import torch.distributed as dist

    started = not dist.is_initialized()
    if started:
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=math.prod(shape))
    elif dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a live process group of {dist.get_world_size()} ranks cannot "
                         f"hold the mesh {dict(zip(axes, shape))}")
    try:
        yield make_mesh(shape, axes, device="cpu")
    finally:
        if started:
            dist.destroy_process_group()


@contextlib.contextmanager
def production_mesh_for_counting(*, multi_pod: bool = False):
    """The production mesh on the CPU for a cost count (:func:`counting_mesh`
    of the mesh's shape)."""
    shape, axes = PRODUCTION_SHAPE[multi_pod]
    with counting_mesh(shape, axes) as mesh:
        yield mesh


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes the global batch shards over (pod folds into data parallelism)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def all_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, axes) -> int:
    """Ranks along one named axis, or along several together (their product)."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in names)


def coordinates(mesh) -> dict[str, int]:
    """The calling rank's index along each named axis of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def axis_index(mesh, axes) -> int:
    """The calling rank's index along one named axis, or along several
    together (the first outermost, as a spec entry folds them)."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    at = coordinates(mesh)
    idx = 0
    for a in names:
        idx = idx * axis_size(mesh, a) + at[a]
    return idx


def _spawned(rank: int, world_size: int, workdir: str, fn: Callable, args: tuple,
             kwargs: dict) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)   # ranks share the host: one intra-op thread each
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT_S))
    try:
        out = fn(*args, **kwargs)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def spawn(fn: Callable, world_size: int, *args, **kwargs) -> list[Any]:
    """``fn(*args, **kwargs)`` in ``world_size`` new processes, each a rank of one
    ``gloo`` group (``spawn`` start method; a ``file://`` store in a fresh
    temporary directory, removed after), and each rank's return value, in
    rank order (passed back through ``torch.save``). ``fn`` must be a
    module-level function. Each rank runs one intra-op thread (ranks share
    the host's cores; more oversubscribe them, tenfold slower at smoke
    size). A rank that raises makes this raise, after the other ranks are
    stopped."""
    import torch
    import torch.multiprocessing as mp

    workdir = tempfile.mkdtemp(prefix="repro_torch_group_")
    try:
        mp.spawn(_spawned, args=(world_size, workdir, fn, args, kwargs), nprocs=world_size,
                 join=True)
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

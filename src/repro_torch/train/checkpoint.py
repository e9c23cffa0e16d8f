"""Checkpoints in the JAX package's format and under its rules (port of
``repro.train.checkpoint``): atomic, async, auto-resume with quarantine.

* **Snapshot, then write.** ``save`` copies every leaf to the host first
  (``.detach().to("cpu", copy=True)``: a copy on the CPU too, since the
  loop's tensors change in place) and serialises the copy, on a background
  thread with ``async_``, so the loop waits only for the copy.
* **Atomic.** The arrays and manifest go to ``step_K.tmp``, which
  ``os.replace`` renames to ``step_K``; a previous ``step_K`` becomes
  ``step_K.old``. A crash mid-write never corrupts a complete checkpoint.
* **The JAX package's layout.** ``arrays.npz`` holds ``params/<path>`` and
  ``opt/step``, ``opt/m/<path>``, ``opt/v/<path>``, each layer list stacked
  ``(nL, ...)`` under its key as the JAX package stacks it
  (``models.model.params_to_numpy``), bf16 widened to f32; then
  ``manifest.json`` with ``step``, ``time``, ``extra`` and ``n_arrays``. A
  checkpoint either package writes restores in the other.
* **Quarantine.** ``latest_step`` renames a directory whose manifest or
  arrays are missing or incomplete to ``*.bad`` and falls back to the
  newest valid step.
* **Restore** checks every array's shape against the ``*_like`` trees and
  casts it to their dtypes, on their device. Given shardings
  (``dist.sharding.param_shardings`` / ``opt_state_shardings``: the elastic
  re-shard), each stacked array goes onto its mesh instead, as a DTensor
  (``distribute_tensor`` with the sharding's placements), and each layer
  list is rebuilt from the slices of its stacked DTensor.
"""
from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch

from repro_torch.device import tensor_device
from repro_torch.models import model as M
from repro_torch.train.optimizer import OptState, tree_map

MANIFEST = "manifest.json"


def _flatten(tree, prefix=""):
    """{"a/b/c": leaf} over nested dicts and NamedTuples, in their order."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def save(ckpt_dir: str, step: int, params: dict, opt_state: OptState,
         extra: dict | None = None, async_: bool = False) -> threading.Thread | None:
    """Snapshot now; serialise (optionally) in the background. The snapshot
    is a host COPY of every leaf, taken before this returns (a blocking copy
    from the card; a copy on the CPU too), so a loop that updates its
    tensors in place may run its next step while the thread writes."""
    snap_p = tree_map(_snapshot, params)
    snap_o = OptState(*(tree_map(_snapshot, x) for x in opt_state))
    extra = dict(extra or {})

    def _write():
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = os.path.join(ckpt_dir, f"step_{step:08d}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        opt = OptState(step=snap_o.step.numpy(), m=M.params_to_numpy(snap_o.m),
                       v=M.params_to_numpy(snap_o.v))
        flat = {f"params/{k}": v for k, v in _flatten(M.params_to_numpy(snap_p)).items()}
        flat.update({f"opt/{k}": v for k, v in _flatten(opt).items()})
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": step, "time": time.time(), "extra": extra,
                    "n_arrays": len(flat)}
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            os.replace(final, final + ".old")
        os.replace(tmp, final)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _snapshot(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _valid(path: str) -> bool:
    m = os.path.join(path, MANIFEST)
    if not os.path.exists(m):
        return False
    try:
        with open(m) as f:
            man = json.load(f)
        data = np.load(os.path.join(path, "arrays.npz"))
        return len(data.files) == man["n_arrays"]
    except Exception:
        return False


def latest_step(ckpt_dir: str) -> int | None:
    """Newest valid checkpoint; quarantine any corrupted ones found."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in sorted(os.listdir(ckpt_dir)):
        if not name.startswith("step_") or name.endswith((".tmp", ".bad", ".old")):
            continue
        path = os.path.join(ckpt_dir, name)
        if _valid(path):
            steps.append(int(name.split("_")[1]))
        else:
            os.replace(path, path + ".bad")  # quarantine
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, params_like: dict, opt_like: OptState,
            shardings: dict | None = None, opt_shardings: OptState | None = None):
    """Load step ``step`` into the shapes, dtypes and device of
    ``params_like``/``opt_like``. Returns (params, opt_state, extra).

    ``shardings`` (``dist.sharding.param_shardings`` of the params: the
    stacked tree's ``NamedSharding``s) restores every params array onto its
    mesh as a DTensor with the sharding's placements, and ``opt_shardings``
    (``opt_state_shardings``) the optimizer state: the elastic re-mesh on
    restore. A layer list is rebuilt from its stacked DTensor's slices."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    data = np.load(os.path.join(path, "arrays.npz"))

    def rebuild(like, prefix: str, shard_tree=None):
        """The params-shaped ``like`` read from ``prefix``: the stacked arrays
        shape-checked, cast to ``like``'s dtypes and split per layer (as
        slices of DTensors on ``shard_tree``'s meshes, where given)."""
        spec = M.stack_layers(like, lambda leaves: torch.empty(
            (len(leaves), *leaves[0].shape), dtype=leaves[0].dtype, device="meta"))
        shard_flat = _flatten(shard_tree) if shard_tree is not None else {}
        flat = {}
        for k, v in _flatten(spec).items():
            arr = data[f"{prefix}/{k}"]
            if arr.shape != tuple(v.shape):
                raise ValueError(f"shape mismatch for {k}: {arr.shape} vs {tuple(v.shape)}")
            flat[k] = arr
            if shard_tree is not None:
                sharding = shard_flat[k]
                t = M.leaf_to_torch(arr, torch.device(sharding.mesh.device_type))
                flat[k] = _distribute(t.to(v.dtype), sharding)

        def unflatten(node, pre=""):
            if isinstance(node, dict):
                return {k: unflatten(v, f"{pre}{k}/") for k, v in node.items()}
            return flat[pre[:-1]]

        if shard_tree is not None:
            tree = M.unstack_layers(unflatten(spec))
            return tree_map(lambda ref, t: t, like, tree)              # like's key order
        tree = M.params_from_numpy(unflatten(spec), device=tensor_device(like))
        return tree_map(lambda ref, t: t.to(ref.dtype), like, tree)   # like's key order

    params = rebuild(params_like, "params", shardings)
    step_arr = data["opt/step"]
    if step_arr.shape != tuple(opt_like.step.shape):
        raise ValueError(f"shape mismatch for step: {step_arr.shape}")
    opt_step = torch.as_tensor(step_arr).to(opt_like.step.dtype)
    if opt_shardings is not None:
        opt_step = _distribute(opt_step.to(opt_shardings.step.mesh.device_type),
                               opt_shardings.step)
    else:
        opt_step = opt_step.to(opt_like.step.device)
    opt = OptState(step=opt_step,
                   m=rebuild(opt_like.m, "opt/m", opt_shardings and opt_shardings.m),
                   v=rebuild(opt_like.v, "opt/v", opt_shardings and opt_shardings.v))
    with open(os.path.join(path, MANIFEST)) as f:
        man = json.load(f)
    return params, opt, man["extra"]


def _distribute(t: torch.Tensor, sharding):
    """``t`` distributed over ``sharding.mesh`` with ``sharding.placements``."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, sharding.mesh, list(sharding.placements))

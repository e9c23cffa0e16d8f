"""The partitioned programs, driven end to end over a mesh: decode and
prefill, and the train step.

``models.model.prefill``/``decode_step`` and ``train.train_step.
train_step``/``train_step_`` with ``mesh=`` are the programs; this module
drives them as a user would, on whatever group is live:

* :func:`shard_params` / :func:`shard_batch` cut a full params tree or batch
  down to the calling rank's shards (``dist.sharding.local_shards``);
* :func:`greedy` takes each row's greedy token from vocab-sharded logits;
* :func:`generate`: a prefill, then greedy decode steps;
* :func:`rank_run`: one rank of a group started by ``launch.mesh.spawn``
  (``gloo``; the CPU, or several ranks on one card): for each model, the
  full weights made or carried over on the rank's device, cut to its shards,
  :func:`generate` on each of a list of meshes, and what the caller
  compares, as numpy: the rank's coordinates, logits, tokens and cache, its
  ``CollectiveCounter`` totals and its kernel launches;
* :func:`count_run`: the same drive on ``meta`` over a ``fake`` group of
  the mesh's size (``launch.mesh.counting_mesh``), counted;
* :func:`train_run`: one rank's partitioned train steps (its shards of the
  params, its ZeRO-1 slices of zero moments, its rows of a global batch) on
  each of a list of meshes, its metrics, its slices gathered back with
  ``dist.sharding.full_tree`` (or, with ``reference``, their errors against
  the unsharded step that rank 0 runs first), its counts;
  :func:`count_train_run` the same drive's ``meta`` count.

Run it on the CPU (two ranks, mesh (data 1, model 2))::

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh, partitioned
    cfg = get_config("llama3-8b", smoke=True).replace(dtype="float32", param_dtype="float32")
    tokens = np.arange(32).reshape(2, 16)        # two 16-token prompts
    out = mesh.spawn(partitioned.rank_run, 2, [(cfg, 0, tokens)], [(1, 2)], 32, 6, "cpu")

(under ``if __name__ == "__main__":``, as the ``spawn`` start method needs).
The train step, on the meshes (1, 2) and (2, 1) of the same two ranks::

    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(1, 256, (8, 16)), "labels": rng.integers(1, 256, (8, 16))}
    out = mesh.spawn(partitioned.train_run, 2, [(cfg, 0, batch)], [(1, 2), (2, 1)], 2, 2, "cpu")
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import torch_dtype
from repro_torch.dist import sharding as shard_lib
from repro_torch.dist.collectives import CollectiveCounter, all_gather
from repro_torch.launch.mesh import coordinates, counting_mesh, make_mesh
from repro_torch.models import model as M
from repro_torch.train.optimizer import (AdamWConfig, OptState, init_opt_state,
                                         tree_leaves, tree_map)
from repro_torch.train.train_step import leaves_by_path, train_step, train_step_

AXES = ("data", "model")
TRAIN_OPT = AdamWConfig()   # the optimizer of the JAX dry run's train_step


def shard_params(params: dict, mesh) -> dict:
    """The calling rank's shards of a full (per-layer) params tree."""
    return shard_lib.local_shards(params, shard_lib.param_shardings(params, mesh), mesh)


def shard_batch(batch: dict, mesh) -> dict:
    """The calling rank's rows of every input of a global batch (tokens,
    labels, a vlm's ``prefix_embeds``, audio's ``src_frames``): its share
    over the data axes, or all of them where the batch does not split."""
    return shard_lib.local_shards(batch, shard_lib.batch_shardings(None, None, mesh, batch),
                                  mesh)


def batch_on(batch, dev) -> dict:
    """A global batch of numpy arrays (or one array: the tokens) as tensors
    on ``dev``: integer ids as int64, float inputs (``prefix_embeds``,
    ``src_frames``) in their own dtype."""
    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v), device=dev)
        out[k] = t if t.is_floating_point() else t.long()
    return out


def _meta_inputs(cfg, extra: dict | None) -> dict:
    """``meta`` stand-ins of a vlm's or audio's inputs beside the tokens:
    ``extra`` maps each name to its global shape, in ``cfg.dtype``."""
    return {k: torch.empty(shape, dtype=torch_dtype(cfg.dtype), device="meta")
            for k, shape in (extra or {}).items()}


def greedy(logits: torch.Tensor, cfg, mesh=None) -> torch.Tensor:
    """(B, 1) greedy tokens from the last position of ``logits`` (B, T, V),
    gathered over ``model`` first where they are vocab-sharded (a padded
    vocab's logits come gathered already: ``models.model.logits_fn``; ties
    go to the lowest token, as ``torch.argmax`` gives them)."""
    last = logits[:, -1]
    if mesh is not None and last.shape[-1] < cfg.vocab_size:
        last = all_gather(last, mesh, "model", dim=-1)
    return last.argmax(-1, keepdim=True)


def generate(params: dict, tokens: torch.Tensor, cfg, max_len: int, steps: int, mesh=None,
             **inputs):
    """``prefill`` of ``tokens`` (and ``inputs``: a vlm's ``prefix_embeds``,
    audio's ``src_frames``), then ``steps`` greedy ``decode_step``s,
    partitioned over ``mesh`` (params and inputs the rank's shards) or not.
    Returns (the logits of the prefill and of each step, (B, 1, V) or the
    rank's (B_rank, 1, V / model); the greedy tokens (B, steps + 1); the
    cache)."""
    logits, cache = M.prefill(params, tokens, cfg, max_len, mesh=mesh, **inputs)
    outs, toks = [logits], [greedy(logits, cfg, mesh)]
    for _ in range(steps):
        logits, cache = M.decode_step(params, cache, toks[-1], cfg, mesh=mesh)
        outs.append(logits)
        toks.append(greedy(logits, cfg, mesh))
    return outs, torch.cat(toks, dim=1), cache


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def rank_run(jobs, meshes, max_len: int, steps: int, device) -> list[list[dict]]:
    """One rank of a live group: for each job ``(cfg, params, tokens)`` and
    each ``(data, model)`` shape of ``meshes`` (each over the whole group),
    :func:`generate` on the rank's shards of ``params`` (the JAX package's
    tree as numpy, carried over with ``params_from_numpy``; or an int seed
    for ``init_params``) and of ``tokens`` (the global (B, S) prompts, numpy;
    or a dict of them beside a vlm's ``prefix_embeds`` or audio's
    ``src_frames``, :func:`batch_on`) on ``device``. Returns, a job each, a
    mesh each: ``coords``, the rank's ``logits`` (a list), ``tokens`` and
    every cache leaf but ``pos`` (``k``/``v``, audio's
    ``cross_k``/``cross_v``) as numpy, ``collectives``
    (``CollectiveCounter`` totals of the whole drive) and ``launches`` (its
    kernel launches)."""
    from repro_torch.kernels import launch_counts, reset_launches

    dev = torch.device(device)
    meshes = [make_mesh(shape, AXES, device=dev) for shape in meshes]
    out = []
    for cfg, params, tokens in jobs:
        if isinstance(params, int):
            full = M.init_params(cfg, torch.Generator(device=dev).manual_seed(params),
                                 device=dev)
        else:
            full = M.params_from_numpy(params, device=dev)
        prompts = batch_on(tokens, dev)
        runs = []
        for mesh in meshes:
            local = shard_params(full, mesh)
            rows = shard_batch(prompts, mesh)
            reset_launches()
            with torch.no_grad(), CollectiveCounter() as counter:
                logits, toks, cache = generate(local, rows.pop("tokens"), cfg, max_len, steps,
                                               mesh, **rows)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            runs.append({"mesh": tuple(mesh.mesh.shape), "coords": coordinates(mesh),
                         "logits": [_numpy(x) for x in logits], "tokens": _numpy(toks),
                         **{k: _numpy(v) for k, v in cache.items() if k != "pos"},
                         "collectives": counter.totals(), "launches": launch_counts()})
            del local, cache
        del full
        out.append(runs)
    return out


def count_run(cfg, shape, batch: int, prompt_len: int, max_len: int, steps: int,
              extra: dict | None = None) -> dict:
    """The ``CollectiveCounter`` totals of :func:`rank_run`'s drive of one
    mesh ``shape``, on ``meta`` over a ``fake`` group of its size: any rank
    counts the same, as the shapes are the same on every rank. ``extra``:
    the global shapes of a vlm's or audio's inputs (:func:`_meta_inputs`)."""
    with counting_mesh(shape, AXES) as mesh:
        local = shard_params(M.init_params(cfg, None, device="meta"), mesh)
        rows = shard_batch({"tokens": torch.zeros((batch, prompt_len), dtype=torch.long,
                                                  device="meta"),
                            **_meta_inputs(cfg, extra)}, mesh)
        with torch.no_grad(), CollectiveCounter() as counter:
            generate(local, rows.pop("tokens"), cfg, max_len, steps, mesh, **rows)
    return counter.totals()


def mesh_axes(shape) -> tuple[str, ...]:
    """A mesh shape's axis names: (data, model), or with three dims the
    multi-pod mesh's (pod, data, model)."""
    return AXES if len(shape) == 2 else ("pod", *AXES)


def _full_params(cfg, params, dev) -> dict:
    if isinstance(params, int):
        return M.init_params(cfg, torch.Generator(device=dev).manual_seed(params), device=dev)
    return M.params_from_numpy(params, device=dev)


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _metrics(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


def _unsharded(params: dict, batch: dict, cfg, steps: int, accum: int):
    """The unsharded in-place step on ``params`` (written): (its metrics a
    step; its params, ``m`` and ``v`` after the steps by stacked path, on
    the host)."""
    state = init_opt_state(params)
    metrics = [_metrics(train_step_(params, state, batch, cfg, TRAIN_OPT, accum))
               for _ in range(steps)]
    host = {name: {k: (torch.stack(v) if isinstance(v, list) else v).cpu()
                   for k, v in leaves_by_path(t).items()}
            for name, t in (("params", params), ("m", state.m), ("v", state.v))}
    return metrics, host


def _free(dev) -> None:
    """Give the card back what the caching allocator holds: two ranks share
    one card, and a rank's cached blocks would starve the other."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _gathered(local, shardings, mesh):
    """(stacked path, full leaf) of a rank's slices, one leaf at a time
    (``dist.sharding.full_tree``; every rank must iterate), a layer list
    stacked."""
    sh = leaves_by_path(shardings)
    for path, leaf in leaves_by_path(local).items():
        full = shard_lib.full_tree(leaf, sh[path], mesh)
        yield path, torch.stack(full) if isinstance(full, list) else full


def train_run(jobs, meshes, steps: int, accum: int, device, *, functional: bool = False,
              reference: bool = False) -> list[list[dict]]:
    """One rank of a live group: for each job ``(cfg, params, batch)`` and
    each ``(data, model)`` shape of ``meshes`` (each over the whole group),
    ``steps`` partitioned train steps (``train_step_``, or with
    ``functional`` ``train_step``) of :data:`TRAIN_OPT` at ``accum`` on
    ``device``: the full params (the JAX package's tree as numpy, or an int
    seed for ``init_params``) cut to the rank's shards, zero moments made at
    its ZeRO-1 slices, its rows of ``batch`` (the global ``tokens`` and
    ``labels``, numpy, and a vlm's ``prefix_embeds`` or audio's
    ``src_frames``). Returns, a job each, a mesh each: ``coords``,
    ``metrics`` (a dict of floats a step), ``collectives``
    (``CollectiveCounter`` totals of the steps), ``launches``,
    ``param_bytes`` / ``moment_bytes`` (what the rank holds), ``wall_s`` and
    ``peak_gb`` (the card's peak allocated memory over the steps; None on
    the CPU), ``check_s`` (the seconds of what follows); then the slices
    gathered back (``dist.sharding.full_tree``)
    as numpy by stacked path (``params``, ``m``, ``v``) on rank 0, or with
    ``reference`` instead their ``errors`` against the unsharded step from
    the same params and batch, which rank 0 runs first (``metrics_ref``; the
    other ranks make their params after it, as ranks may share one card):
    for each tree the max |err| and the max over leaves of |err| over the
    leaf's max |x|."""
    import torch.distributed as dist

    from repro_torch.kernels import launch_counts, reset_launches

    dev = torch.device(device)
    meshes = [make_mesh(shape, mesh_axes(shape), device=dev) for shape in meshes]
    rank0 = dist.get_rank() == 0
    out = []
    for cfg, params, batch in jobs:
        gbatch = batch_on(batch, dev)
        ref = None
        if reference:   # the other ranks make their params after it: ranks may share a card
            if rank0:
                ref = _unsharded(_full_params(cfg, params, dev), gbatch, cfg, steps, accum)
            _free(dev)
            dist.barrier()
        full = _full_params(cfg, params, dev)
        _free(dev)
        specs = M.param_specs(cfg)
        runs = []
        for i, mesh in enumerate(meshes):
            local = shard_params(full, mesh)
            if i + 1 < len(meshes):    # a replicated leaf is the full tree's: copy it
                local = tree_map(lambda t, f: t.clone() if t is f else t, local, full)
            else:
                del full
            state = shard_lib.local_opt_state(cfg, mesh, dev)
            rows = shard_batch(gbatch, mesh)
            reset_launches()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            metrics = []
            with CollectiveCounter() as counter:
                for _ in range(steps):
                    if functional:
                        local, state, m = train_step(local, state, rows, cfg, TRAIN_OPT, accum,
                                                     mesh=mesh)
                    else:
                        m = train_step_(local, state, rows, cfg, TRAIN_OPT, accum, mesh=mesh)
                    metrics.append(_metrics(m))
            wall = time.perf_counter() - t0
            run = {"mesh": tuple(mesh.mesh.shape), "coords": coordinates(mesh),
                   "metrics": metrics, "collectives": counter.totals(),
                   "launches": launch_counts(), "param_bytes": _tree_bytes(local),
                   "moment_bytes": _tree_bytes(state.m) + _tree_bytes(state.v),
                   "wall_s": wall, "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9
                   if dev.type == "cuda" else None}
            o_sh = shard_lib.opt_state_shardings(OptState(None, specs, specs), mesh)
            trees = (("params", local, shard_lib.param_shardings(specs, mesh)),
                     ("m", state.m, o_sh.m), ("v", state.v, o_sh.v))
            if reference:
                run["errors"] = {}
                if rank0:
                    run["metrics_ref"] = ref[0]
            t0 = time.perf_counter()
            for name, tree, sh in trees:
                err = {"max_abs_err": 0.0, "max_err_over_max": 0.0}
                got = {}
                for path, leaf in _gathered(tree, sh, mesh):
                    if not rank0:
                        continue
                    if reference:   # on the leaf's device: the host copy moves once
                        want = ref[1][name][path].to(leaf.device).float()
                        d = float((leaf.float() - want).abs().max())
                        err["max_abs_err"] = max(err["max_abs_err"], d)
                        err["max_err_over_max"] = max(
                            err["max_err_over_max"], d / max(float(want.abs().max()), 1e-30))
                        del want
                    else:
                        got[path] = _numpy(leaf)
                    del leaf
                if reference:
                    run["errors"][name] = err
                elif rank0:
                    run[name] = got
            run["check_s"] = time.perf_counter() - t0
            runs.append(run)
            del local, state
            _free(dev)
        out.append(runs)
    return out


def count_train_run(cfg, shape, batch: int, seq_len: int, steps: int, accum: int,
                    extra: dict | None = None) -> dict:
    """The ``CollectiveCounter`` totals of :func:`train_run`'s steps on one
    mesh ``shape``, on ``meta`` over a ``fake`` group of its size (any rank
    counts the same); ``extra`` as :func:`count_run`'s."""
    with counting_mesh(shape, mesh_axes(shape)) as mesh:
        local = shard_params(M.init_params(cfg, None, device="meta"), mesh)
        state = shard_lib.local_opt_state(cfg, mesh, "meta")
        gbatch = {k: torch.zeros((batch, seq_len), dtype=torch.long, device="meta")
                  for k in ("tokens", "labels")}
        rows = shard_batch({**gbatch, **_meta_inputs(cfg, extra)}, mesh)
        with CollectiveCounter() as counter:
            for _ in range(steps):
                train_step_(local, state, rows, cfg, TRAIN_OPT, accum, mesh=mesh)
    return counter.totals()

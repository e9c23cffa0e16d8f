"""The partitioned decode and prefill programs, driven end to end over a mesh.

``models.model.prefill``/``decode_step`` with ``mesh=`` are the programs;
this module drives them as a user would, on whatever group is live:

* :func:`shard_params` / :func:`shard_rows` cut a full params tree or batch
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
  the mesh's size (``launch.mesh.counting_mesh``), counted.

Run it on the CPU (two ranks, mesh (data 1, model 2))::

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh, partitioned
    cfg = get_config("llama3-8b", smoke=True).replace(dtype="float32", param_dtype="float32")
    tokens = np.arange(32).reshape(2, 16)        # two 16-token prompts
    out = mesh.spawn(partitioned.rank_run, 2, [(cfg, 0, tokens)], [(1, 2)], 32, 6, "cpu")

(under ``if __name__ == "__main__":``, as the ``spawn`` start method needs).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist import sharding as shard_lib
from repro_torch.dist.collectives import CollectiveCounter, all_gather
from repro_torch.launch.mesh import coordinates, counting_mesh, make_mesh
from repro_torch.models import model as M

AXES = ("data", "model")


def shard_params(params: dict, mesh) -> dict:
    """The calling rank's shards of a full (per-layer) params tree."""
    return shard_lib.local_shards(params, shard_lib.param_shardings(params, mesh), mesh)


def shard_rows(tokens: torch.Tensor, mesh) -> torch.Tensor:
    """The calling rank's rows of a global batch (its share over the data
    axes, or all of them where the batch does not split)."""
    batch = {"tokens": tokens}
    return shard_lib.local_shards(batch, shard_lib.batch_shardings(None, None, mesh, batch),
                                  mesh)["tokens"]


def greedy(logits: torch.Tensor, cfg, mesh=None) -> torch.Tensor:
    """(B, 1) greedy tokens from the last position of ``logits`` (B, T, V),
    gathered over ``model`` first where they are vocab-sharded (ties go to
    the lowest token, as ``torch.argmax`` gives them)."""
    last = logits[:, -1]
    if mesh is not None and last.shape[-1] < cfg.vocab_size:
        last = all_gather(last, mesh, "model", dim=-1)
    return last.argmax(-1, keepdim=True)


def generate(params: dict, tokens: torch.Tensor, cfg, max_len: int, steps: int, mesh=None):
    """``prefill`` of ``tokens``, then ``steps`` greedy ``decode_step``s,
    partitioned over ``mesh`` (params and tokens the rank's shards) or not.
    Returns (the logits of the prefill and of each step, (B, 1, V) or the
    rank's (B_rank, 1, V / model); the greedy tokens (B, steps + 1); the
    cache)."""
    logits, cache = M.prefill(params, tokens, cfg, max_len, mesh=mesh)
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
    for ``init_params``) and of ``tokens`` (the global (B, S) prompts, numpy)
    on ``device``. Returns, a job each, a mesh each: ``coords``, the rank's
    ``logits`` (a list), ``tokens`` and ``k``/``v`` as numpy,
    ``collectives`` (``CollectiveCounter`` totals of the whole drive) and
    ``launches`` (its kernel launches)."""
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
        prompts = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=dev)
        runs = []
        for mesh in meshes:
            local = shard_params(full, mesh)
            rows = shard_rows(prompts, mesh)
            reset_launches()
            with torch.no_grad(), CollectiveCounter() as counter:
                logits, toks, cache = generate(local, rows, cfg, max_len, steps, mesh)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            runs.append({"mesh": tuple(mesh.mesh.shape), "coords": coordinates(mesh),
                         "logits": [_numpy(x) for x in logits], "tokens": _numpy(toks),
                         "k": _numpy(cache["k"]), "v": _numpy(cache["v"]),
                         "collectives": counter.totals(), "launches": launch_counts()})
            del local, cache
        del full
        out.append(runs)
    return out


def count_run(cfg, shape, batch: int, prompt_len: int, max_len: int, steps: int) -> dict:
    """The ``CollectiveCounter`` totals of :func:`rank_run`'s drive of one
    mesh ``shape``, on ``meta`` over a ``fake`` group of its size: any rank
    counts the same, as the shapes are the same on every rank."""
    with counting_mesh(shape, AXES) as mesh:
        local = shard_params(M.init_params(cfg, None, device="meta"), mesh)
        rows = shard_rows(torch.zeros((batch, prompt_len), dtype=torch.long, device="meta"),
                          mesh)
        with torch.no_grad(), CollectiveCounter() as counter:
            generate(local, rows, cfg, max_len, steps, mesh)
    return counter.totals()

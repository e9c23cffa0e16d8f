"""The train step: loss, gradients by autograd, clipping and AdamW, with
gradient accumulation (port of ``repro.train.train_step``; autograd in place
of ``jax.value_and_grad``).

:func:`train_step` is the functional step, as the JAX one: it returns new
params and a new optimizer state. :func:`train_step_` is its in-place twin
(``optimizer.adamw_update_``), and :class:`TrainGraphs` holds it as one
captured CUDA graph, the counterpart of the jitted ``train_step``: forward,
backward (the ``remat`` recompute included), every ``accum`` microbatch
(unrolled, as the JAX ``lax.scan`` is), the clip and the AdamW update, over
params and moments that keep their addresses from step to step. It is a
``core.interleave.GraphCache``, as the engine's ``StepGraphs`` is: a key's
first call runs eagerly (on a side stream, so that autograd's lazy state is
built outside the graph; it is the real step), its second captures and
replays, later calls replay; ``interleave.eager()`` turns capture off; a
capture that fails raises ``interleave.CaptureError`` naming the frame that
broke it. On the CPU the step runs eagerly.

**Partitioned** (``mesh=``: the JAX dry run's ``train_4k`` program for the
dense family, gemma2 included, vlm and audio,
``models.model.check_partitioned``): each rank holds its ``model`` shard of
the params (``launch.partitioned.shard_params``; a padded vocab's pad rows
or columns stay zero), its ZeRO-1 slice of the f32 moments in the stacked
layout (``dist.sharding.local_opt_state``) and its rows of the batch (a
vlm's ``prefix_embeds``, audio's ``src_frames`` beside the tokens). The
step:

1. the rank's rows in ``accum`` microbatches, each ``models.model.loss_fn``
   with ``mesh`` (Megatron tensor parallelism over ``model``, autograd
   through the collectives), the gradients summed in f32 into one
   layer-stacked buffer a leaf (each layer's gradient added into its row:
   no per-step stack of the per-layer gradients);
2. the loss: the rank's mean over its rows, over the data size, all-reduced
   over the batch axes (``("pod", "data")`` on the multi-pod mesh);
3. the leaves replicated over ``model`` whose gradients are partial there
   (``models.model.partial_over_model``: the norm scales under sequence
   parallelism) summed over ``model`` in one flat all-reduce;
4. each gradient reduce-scattered over the batch axes along the dim its
   moment folds them into (``dist.sharding.zero1_plan``; the layer dim
   where it divides, so a data rank receives its own layers' gradients
   only), or all-reduced where no dim divides; then over ``accum`` and the
   data size, the global batch's mean;
5. AdamW (``train.optimizer``) on the rank's slice of each param and its
   moments, the clip's norm the unsharded one (one f32 all-reduce over the
   mesh);
6. the updated slices all-gathered over the batch axes, so every data rank
   holds its ``model`` shard whole.

It returns the same ``{"loss", "lr", "grad_norm"}`` on every rank, equal to
the unsharded step's up to the order of the reductions. The gradients are
accumulated and reduced in f32 at any ``accum``. ``mesh=None`` is the
single-rank step, unchanged.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import interleave
from repro_torch.dist import sharding as shard_lib
from repro_torch.dist.collectives import all_gather, all_reduce, reduce_scatter
from repro_torch.launch.mesh import axis_index, axis_size, batch_axes
from repro_torch.models import model as M
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_update, adamw_update_,
                                         tree_leaves, tree_map)


def loss_for_batch(params: dict, batch: dict, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    return M.loss_fn(params, batch, cfg, mesh=mesh)


def value_and_grad(params: dict, batch: dict, cfg: ModelConfig):
    """(loss, grads): the grads a tree shaped like ``params``, each leaf in
    its param's dtype (zeros for a param the loss does not reach). ``params``
    are not written: autograd runs on detached leaves that share their
    storage."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_for_batch(live, batch, cfg)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), live)


def _loss_and_grads(params: dict, batch: dict, cfg: ModelConfig, accum: int):
    """The step's loss and grads; ``accum`` > 1 runs the microbatches in
    order and divides their loss and f32 grad sums by ``accum``."""
    if accum == 1:
        return value_and_grad(params, batch, cfg)
    loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    for mb in _microbatches(batch, accum):
        li, gi = value_and_grad(params, mb, cfg)
        loss = loss + li
        grads = tree_map(lambda a, b: a + b.float(), grads, gi)
    return loss / accum, tree_map(lambda g: g / accum, grads)


def _microbatches(batch: dict, accum: int) -> list[dict]:
    return [{k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i] for k, v in batch.items()}
            for i in range(accum)]


def _flat(tree: dict, prefix: str = "") -> dict:
    """A nested dict's leaves by their ``/``-joined paths, in order."""
    out: dict = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def leaves_by_path(params: dict) -> dict:
    """The leaves of a params-shaped tree by stacked path: a tensor, or for a
    leaf of a per-layer list the list of every layer's tensor (a stacked
    tree's leaves as they are)."""
    if any(isinstance(params.get(k), list) for k in M.STACKED):
        params = M.stack_layers(params, list)
    return _flat(params)


@functools.lru_cache(maxsize=16)
def _plan(cfg: ModelConfig, mesh) -> dict:
    """``dist.sharding.zero1_plan``, kept for the process. It reads shapes
    off a ``meta`` params tree: host bookkeeping, which no dispatch mode
    around the step sees (a ``launch.costrun.CostCounter`` counts the step
    alone, whether or not its plan was made)."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        return shard_lib.zero1_plan(cfg, mesh)


def _partitioned_grads(params: dict, batch: dict, cfg: ModelConfig, accum: int, mesh,
                       plan: dict):
    """(the rank's mean loss over its rows, its f32 gradient sums over its
    ``accum`` microbatches, by stacked path: one buffer a leaf, a layer's
    gradient added into its row). Each param's gradient is added as soon as
    autograd has it and then dropped, so a microbatch's gradients never
    exist all at once beside the sums."""
    dev = batch["tokens"].device
    acc = {path: torch.zeros(plan[path].param_shape, dtype=torch.float32, device=dev)
           for path in plan}
    loss = torch.zeros((), dtype=torch.float32, device=dev)

    def add_into(row):
        def hook(t):
            row.add_(t.grad)
            t.grad = None
        return hook

    for mb in _microbatches(batch, accum):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            for path, leaf in leaves_by_path(live).items():
                rows = acc[path] if isinstance(leaf, list) else [acc[path]]
                for t, row in zip(leaf if isinstance(leaf, list) else [leaf], rows):
                    t.register_post_accumulate_grad_hook(add_into(row))
            li = loss_for_batch(live, mb, cfg, mesh)
            li.backward()
        loss = loss + li.detach()
    return loss / accum, acc


def _param_slice(leaf, z, mesh, ba):
    """The rank's ZeRO-1 slice of one param leaf (``z``: its
    ``dist.sharding.Zero1Leaf``): a view of a whole tensor, or the stack of
    the slices of a layer list (the rank's own layers under a layer-dim
    fold)."""
    if z.fold is None:
        return torch.stack(leaf) if isinstance(leaf, list) else leaf
    part = z.param_shape[z.fold] // axis_size(mesh, ba)
    lo = axis_index(mesh, ba) * part
    if not isinstance(leaf, list):
        return leaf.narrow(z.fold, lo, part)
    if z.fold == 0:
        return torch.stack(leaf[lo:lo + part])
    return torch.stack([t.narrow(z.fold - 1, lo, part) for t in leaf])


def _partitioned_step(params: dict, opt_state: OptState, batch: dict, cfg: ModelConfig,
                      opt_cfg: AdamWConfig, accum: int, mesh, in_place: bool):
    """The partitioned step (the module's docstring), functional or in place:
    (params', opt_state', metrics)."""
    plan = _plan(cfg, mesh)
    ba = batch_axes(mesh)
    nb = axis_size(mesh, ba)
    loss, acc = _partitioned_grads(params, batch, cfg, accum, mesh, plan)
    loss = all_reduce(loss / nb, mesh, ba)
    partial = M.partial_over_model(cfg, mesh, M.stack_len(cfg, batch))
    if partial:
        flat = all_reduce(torch.cat([acc[p].reshape(-1) for p in partial]), mesh, "model")
        for p, piece in zip(partial, flat.split([acc[p].numel() for p in partial])):
            acc[p].copy_(piece.view_as(acc[p]))
    grads = {path: (all_reduce(a, mesh, ba) if plan[path].fold is None else
                    reduce_scatter(a, mesh, ba, dim=plan[path].fold)).div_(accum * nb)
             for path, a in acc.items()}
    del acc
    leaves = leaves_by_path(params)
    slices = {path: _param_slice(leaves[path], z, mesh, ba) for path, z in plan.items()}
    state = OptState(opt_state.step, _flat(opt_state.m), _flat(opt_state.v))
    weights = {path: z.norm_weight for path, z in plan.items()}
    update = adamw_update_ if in_place else adamw_update
    new, new_state, stats = update(slices, grads, state, opt_cfg, mesh=mesh,
                                   norm_weights=weights)
    out = {}
    for path, z in plan.items():
        leaf = leaves[path]
        full = new[path] if z.fold is None else all_gather(new[path], mesh, ba, dim=z.fold)
        if not in_place:
            out[path] = list(full.unbind(0)) if isinstance(leaf, list) else full
        elif isinstance(leaf, list):
            for t, f in zip(leaf, full.unbind(0)):
                t.copy_(f)
        elif full is not leaf:
            leaf.copy_(full)
    metrics = {"loss": loss, **stats}
    if in_place:
        return params, opt_state, metrics
    return (M.unstack_layers(_nest(out)),
            OptState(new_state.step, _nest(new_state.m), _nest(new_state.v)), metrics)


def train_step(params: dict, opt_state: OptState, batch: dict, cfg: ModelConfig,
               opt_cfg: AdamWConfig, accum: int = 1, *, mesh=None):
    """batch: {tokens, labels, [prefix_embeds | src_frames]} as tensors on the
    params' device. ``accum`` > 1 splits the batch into that many
    microbatches, run in order; their losses and f32 grad sums are divided by
    ``accum``. Returns (params', opt_state', {"loss", "lr", "grad_norm"}).
    With ``mesh`` the partitioned step (the module's docstring): params,
    opt_state and batch the rank's, and so are params' and opt_state'."""
    if mesh is not None:
        return _partitioned_step(params, opt_state, batch, cfg, opt_cfg, accum, mesh, False)
    loss, grads = _loss_and_grads(params, batch, cfg, accum)
    new_params, new_opt, stats = adamw_update(params, grads, opt_state, opt_cfg)
    return new_params, new_opt, {"loss": loss, **stats}


def train_step_(params: dict, opt_state: OptState, batch: dict, cfg: ModelConfig,
                opt_cfg: AdamWConfig, accum: int = 1, *, mesh=None) -> dict:
    """:func:`train_step` IN PLACE: ``params`` and ``opt_state`` are written
    (``adamw_update_``), bit for bit what the functional step returns (with
    ``mesh``, the rank's shards and slices). Returns {"loss", "lr",
    "grad_norm"}."""
    if mesh is not None:
        return _partitioned_step(params, opt_state, batch, cfg, opt_cfg, accum, mesh, True)[2]
    loss, grads = _loss_and_grads(params, batch, cfg, accum)
    _, _, stats = adamw_update_(params, grads, opt_state, opt_cfg)
    return {"loss": loss, **stats}


class TrainGraphs(interleave.GraphCache):
    """The captured in-place train step of one training loop
    (``interleave.GraphCache``'s contract; its warm-up runs on a side
    stream).

    A key is ``cfg``, ``opt_cfg``, ``accum``, the mesh (``None``: the
    single-rank step; a ``fake`` or NCCL group captures, a ``gloo`` one
    staging CUDA tensors through the host does not), the batch's names,
    shapes and dtypes and every params and moments tensor's address, dtype,
    shape and stride; the batch is copied into the graph's static buffers each step
    (from pinned host memory, or from the device). The metrics a replay
    returns are static outputs that the next replay overwrites: read them
    first."""

    def key(self, params: dict, opt_state: OptState, batch: dict, cfg: ModelConfig,
            opt_cfg: AdamWConfig, accum: int, mesh=None) -> tuple:
        return ("train_step", cfg, opt_cfg, int(accum), mesh,
                tuple((k, v.shape, v.dtype) for k, v in batch.items()),
                self.signature(params), self.signature(tuple(opt_state)))

    def step(self, params: dict, opt_state: OptState, batch: dict, cfg: ModelConfig,
             opt_cfg: AdamWConfig, accum: int = 1, mesh=None) -> dict:
        """One in-place train step (:func:`train_step_`) on ``params`` and
        ``opt_state``; ``batch`` on the host or the device. Returns the
        metrics."""
        names = tuple(batch)
        return self.run(
            "train_step", cfg,
            lambda: self.key(params, opt_state, batch, cfg, opt_cfg, accum, mesh),
            tuple(batch.values()),
            lambda xs, side: (train_step_(params, opt_state, dict(zip(names, xs)), cfg,
                                          opt_cfg, accum, mesh=mesh),),
            warm_on_side=True)[0]

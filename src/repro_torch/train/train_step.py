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
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import interleave
from repro_torch.models import model as M
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_update, adamw_update_,
                                         tree_leaves, tree_map)


def loss_for_batch(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    return M.loss_fn(params, batch, cfg)


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
    for i in range(accum):
        mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
              for k, v in batch.items()}
        li, gi = value_and_grad(params, mb, cfg)
        loss = loss + li
        grads = tree_map(lambda a, b: a + b.float(), grads, gi)
    return loss / accum, tree_map(lambda g: g / accum, grads)


def train_step(params: dict, opt_state: OptState, batch: dict, cfg: ModelConfig,
               opt_cfg: AdamWConfig, accum: int = 1):
    """batch: {tokens, labels, [prefix_embeds | src_frames]} as tensors on the
    params' device. ``accum`` > 1 splits the batch into that many
    microbatches, run in order; their losses and f32 grad sums are divided by
    ``accum``. Returns (params', opt_state', {"loss", "lr", "grad_norm"})."""
    loss, grads = _loss_and_grads(params, batch, cfg, accum)
    new_params, new_opt, stats = adamw_update(params, grads, opt_state, opt_cfg)
    return new_params, new_opt, {"loss": loss, **stats}


def train_step_(params: dict, opt_state: OptState, batch: dict, cfg: ModelConfig,
                opt_cfg: AdamWConfig, accum: int = 1) -> dict:
    """:func:`train_step` IN PLACE: ``params`` and ``opt_state`` are written
    (``adamw_update_``), bit for bit what the functional step returns.
    Returns {"loss", "lr", "grad_norm"}."""
    loss, grads = _loss_and_grads(params, batch, cfg, accum)
    _, _, stats = adamw_update_(params, grads, opt_state, opt_cfg)
    return {"loss": loss, **stats}


class TrainGraphs(interleave.GraphCache):
    """The captured in-place train step of one training loop
    (``interleave.GraphCache``'s contract; its warm-up runs on a side
    stream).

    A key is ``cfg``, ``opt_cfg``, ``accum``, the batch's names, shapes and
    dtypes and every params and moments tensor's address, dtype, shape and
    stride; the batch is copied into the graph's static buffers each step
    (from pinned host memory, or from the device). The metrics a replay
    returns are static outputs that the next replay overwrites: read them
    first."""

    def key(self, params: dict, opt_state: OptState, batch: dict, cfg: ModelConfig,
            opt_cfg: AdamWConfig, accum: int) -> tuple:
        return ("train_step", cfg, opt_cfg, int(accum),
                tuple((k, v.shape, v.dtype) for k, v in batch.items()),
                self.signature(params), self.signature(tuple(opt_state)))

    def step(self, params: dict, opt_state: OptState, batch: dict, cfg: ModelConfig,
             opt_cfg: AdamWConfig, accum: int = 1) -> dict:
        """One in-place train step (:func:`train_step_`) on ``params`` and
        ``opt_state``; ``batch`` on the host or the device. Returns the
        metrics."""
        names = tuple(batch)
        return self.run(
            "train_step", cfg, lambda: self.key(params, opt_state, batch, cfg, opt_cfg, accum),
            tuple(batch.values()),
            lambda xs, side: (train_step_(params, opt_state, dict(zip(names, xs)), cfg,
                                          opt_cfg, accum),),
            warm_on_side=True)[0]

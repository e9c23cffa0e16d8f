"""The train step: loss, gradients by autograd, clipping and AdamW, with
gradient accumulation (port of ``repro.train.train_step``; autograd in place
of ``jax.value_and_grad``, eager in place of ``jax.jit``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.train.optimizer import AdamWConfig, OptState, adamw_update, tree_leaves, tree_map


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


def train_step(params: dict, opt_state: OptState, batch: dict, cfg: ModelConfig,
               opt_cfg: AdamWConfig, accum: int = 1):
    """batch: {tokens, labels, [prefix_embeds | src_frames]} as tensors on the
    params' device. ``accum`` > 1 splits the batch into that many
    microbatches, run in order; their losses and f32 grad sums are divided by
    ``accum``. Returns (params', opt_state', {"loss", "lr", "grad_norm"})."""
    if accum == 1:
        loss, grads = value_and_grad(params, batch, cfg)
    else:
        loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)
        for i in range(accum):
            mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
                  for k, v in batch.items()}
            li, gi = value_and_grad(params, mb, cfg)
            loss = loss + li
            grads = tree_map(lambda a, b: a + b.float(), grads, gi)
        loss = loss / accum
        grads = tree_map(lambda g: g / accum, grads)
    new_params, new_opt, stats = adamw_update(params, grads, opt_state, opt_cfg)
    return new_params, new_opt, {"loss": loss, **stats}

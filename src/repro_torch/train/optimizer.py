"""AdamW with a warmup-cosine schedule and global-norm clipping (port of
``repro.train.optimizer``), on plain tensors.

The state mirrors the params tree: f32 first and second moments ``m``/``v``
beside an int32 step. :func:`adamw_update` is functional, as the JAX one: it
returns new params and a new state and writes none of its inputs.
:func:`adamw_update_` is its in-place twin for a loop that owns its tensors
(the captured train step): the same arithmetic in the same order, written
into the params, moments and step it is given, bit for bit the functional
result. The step, the learning rate, the bias corrections and the clip scale
stay tensors on the params' device throughout (nothing comes back to the
host inside a step).

**Over shards** (``mesh=``, the partitioned train step): the trees are a
rank's matching slices of the params, gradients and moments (any tree
shape), updated element by element as the whole tree would be; only the
clip's norm reaches across ranks. Each leaf adds its sum of squares times
its weight (``norm_weights``: one over the ranks that hold the same slice,
so a leaf replicated over ``model``, or over every data rank, counts once),
then one f32 all-reduce over the whole mesh gives every rank the unsharded
norm. The step counter and the learning rate stay replicated.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.device import tensor_device

@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensor leaves of nested dicts and lists (``rest``:
    trees of the same shape, passed leaf by leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def init_opt_state(params: dict) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(step=torch.zeros((), dtype=torch.int32, device=tensor_device(params)),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def lr_at(step, cfg: AdamWConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an int tensor), in f32 as the
    JAX package computes it: linear warmup to ``lr``, then a cosine to
    ``min_lr_ratio · lr`` at ``total_steps``."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps).float()
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def clip_by_global_norm(grads: Any, max_norm: float, *, mesh=None, norm_weights: Any = None):
    """(grads scaled by min(1, max_norm / ‖grads‖) in f32, each cast back to
    its dtype; the f32 global norm). With ``mesh`` the grads are a rank's
    slices and the norm the unsharded one (the module's docstring)."""
    if mesh is None:
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
    else:
        from repro_torch.dist.collectives import all_reduce
        from repro_torch.launch.mesh import all_axes

        sq = sum(torch.sum(torch.square(g.float())) * w
                 for g, w in zip(tree_leaves(grads), tree_leaves(norm_weights)))
        gn = torch.sqrt(all_reduce(sq, mesh, all_axes(mesh)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: OptState, cfg: AdamWConfig, *,
                 mesh=None, norm_weights: Any = None):
    """One AdamW step in f32 (clipped grads, bias-corrected moments, decoupled
    weight decay), each param cast back to its dtype. Returns (params',
    state', {"lr", "grad_norm"}). With ``mesh``, over a rank's slices (the
    module's docstring)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, mesh=mesh,
                                       norm_weights=norm_weights)
    step = state.step + 1
    lr = lr_at(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    def upd(p, g, m, v):
        gf = g.float()
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m2, v2

    out = tree_map(upd, params, grads, state.m, state.v)   # leaves: (p', m', v')
    new_p, new_m, new_v = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    return new_p, OptState(step=step, m=new_m, v=new_v), {"lr": lr, "grad_norm": gnorm}


@torch.no_grad()
def adamw_update_(params: dict, grads: dict, state: OptState, cfg: AdamWConfig, *,
                  mesh=None, norm_weights: Any = None):
    """:func:`adamw_update` IN PLACE: the new params, ``m``, ``v`` and step are
    written into ``params`` and ``state``'s tensors (the same expressions in
    the same order, so the bits are the functional update's). Returns
    (params, state, {"lr", "grad_norm"}), the objects it was given."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, mesh=mesh,
                                       norm_weights=norm_weights)
    step = state.step.add_(1)
    lr = lr_at(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    def upd(p, g, m, v):
        gf = g.float()
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * gf * gf)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))

    tree_map(upd, params, grads, state.m, state.v)
    return params, state, {"lr": lr, "grad_norm": gnorm}

"""Sharding rules for params, optimizer state, batches and KV caches (port of
``repro.dist.sharding``), over ``torch.distributed`` device meshes.

Megatron-style tensor parallelism over the ``model`` axis:

* column-parallel weights (``w_gate``/``w_up``/``wq``/``wk``/``wv``/...) shard
  their OUTPUT dim; row-parallel weights (``w_down``/``wo``/...) shard their
  INPUT (contracted) dim: one all-reduce per block.
* MoE expert tables shard the EXPERT dim (expert parallelism).
* the embedding table shards its vocab rows; the LM head its vocab columns
  (GSPMD pads an odd vocab: the one sanctioned padding exception, below).
* any other dim not divisible by :data:`MODEL_SHARD` stays replicated:
  weights are never silently padded.

**The padded vocab.** GSPMD splits a vocab that ``model`` does not divide
(internvl2-2b's 92,553, seamless-m4t-large-v2's 256,206) by padding it to
``ceil(V / n) * n`` with zeros, each rank holding its equal part and the last
rank the pad. :class:`NamedSharding` records such a dim's full size
(``padded``; :func:`param_shardings`, :func:`opt_state_shardings`), so that
:func:`local_shards` pads the rank's part and :func:`full_tree` strips the pad
again. A pad row of the embedding is never looked up, and the model masks the
head's pad columns out of the loss and drops them from the logits
(``models.model.logits_fn``), so they stay zero through the train step.

Optimizer moments additionally fold the ``data`` axis into their first
replicated dim (ZeRO-1: each data rank owns a slice of the f32 state).
Decode KV caches shard batch over the data axes when the batch is wide, and
fold ALL mesh axes into the sequence dim for batch-1 long-context decode.

**Specs.** A spec is a tuple with one entry per leading tensor dim: ``None``
(replicated), an axis name, or a tuple of axis names in the mesh's dim order
(the dim is split over all of them, the first outermost). It equals
``tuple(PartitionSpec(...))`` of the JAX package's spec. :class:`NamedSharding`
pairs it with a mesh; its ``placements`` are DTensor's, one per mesh dim:
``Shard(d)`` where the spec puts that axis on dim ``d`` (on both mesh dims for
a two-axis entry), else ``Replicate()``.

**Stacked trees.** The rules read a leaf's tree path and shape. The JAX
package stacks each layer list ``(nL, ...)``; the port keeps per-layer
lists. So the rules run on the stacked tree (``models.model.stack_layers``,
the layout of ``models.model.param_specs`` and of the checkpoints), where
paths and specs equal the JAX package's leaf for leaf; a per-layer tree is
stacked first, on the ``meta`` device. A per-layer leaf takes its stacked
leaf's spec without the first (layer) entry: it is the slice ``dt[i]`` of the
distributed stacked tensor (``train.checkpoint.restore``). Where a rule put a
mesh axis on the layer dim (ZeRO-1 folds ``data`` there on a stacked moment),
that slice is replicated over the axis: DTensor gathers it on the select.

**Local shards.** :func:`local_shards` cuts a full tree (params, cache,
batch) down to the calling rank's slices by its mesh coordinates, the input
of the partitioned program (``models.model.decode_step``/``prefill`` with
``mesh=``), which takes plain tensors, not DTensors.

**ZeRO-1 slices.** A per-layer leaf's slice drops the layer entry, which is
right for a DTensor restore but is not ZeRO-1: where ``_with_data_axis``
folds the batch axes into the layer dim of a stacked moment (llama3-8b at
(data 16, model 16): 32 layers over 16 data ranks), data rank r owns the
moments of its own layers only. So the partitioned train step keeps its
moments in the stacked layout, each leaf cut by its whole spec:
:func:`local_opt_state` makes zero moments of those shapes without a full
tree, :func:`zero1_plan` gives each stacked leaf's folded dim and its local
shapes, and :func:`full_tree` gathers any rank's slices (params, per-layer
or stacked; moments) back to the full tree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.launch.mesh import MODEL_SHARD, all_axes, axis_index, axis_size, batch_axes
from repro_torch.models.model import STACKED, param_specs, stack_layers
from repro_torch.train.optimizer import OptState

# row-parallel weights: contract the sharded input dim (Megatron pair rule)
_ROW_PARALLEL = {"w_down", "wo", "w_out", "w_b", "cm_wv"}


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``.
    ``padded``: ``(dim, full size)`` of each vocab dim that the spec splits
    (the module's "padded vocab"), empty for every other leaf."""
    mesh: Any
    spec: tuple
    padded: tuple = ()

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim, for ``distribute_tensor``."""
        from torch.distributed.tensor import Replicate, Shard

        names = all_axes(self.mesh)
        out = [Replicate()] * len(names)
        for dim, e in enumerate(self.spec):
            axes = () if e is None else (e,) if isinstance(e, str) else tuple(e)
            if list(axes) != sorted(axes, key=names.index):
                raise ValueError(f"spec {self.spec}: the axes {axes} of dim {dim} are not "
                                 f"in the mesh's dim order {names}")
            for a in axes:
                out[names.index(a)] = Shard(dim)
        return tuple(out)


def _shape(leaf) -> tuple:
    """A leaf's shape: a tensor's (meta or not), or a ``(shape, dtype)`` pair
    of ``models.model.decode_cache_specs``."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf[0])


def _map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over the leaves of nested dicts, ``path`` their keys
    joined by ``/`` (the JAX package's ``_path_str``)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def stacked(tree: dict) -> dict:
    """``tree`` with each per-layer list under a :data:`STACKED` key stacked
    ``(nL, ...)`` on the ``meta`` device (no copy); a stacked tree as it is."""
    if not any(isinstance(tree.get(k), list) for k in STACKED):
        return tree
    return stack_layers(tree, lambda leaves: torch.empty(
        (len(leaves), *leaves[0].shape), dtype=leaves[0].dtype, device="meta"))


def _divisible(shape, dim: int) -> bool:
    return shape[dim] % MODEL_SHARD == 0


def param_pspec(path: str, leaf) -> tuple:
    """Spec of one parameter leaf addressed by its (stacked-tree) path."""
    shape = _shape(leaf)
    nd = len(shape)
    parts = path.split("/")
    name = parts[-1]
    if nd <= 1 or name in ("scale", "bias") or "norm" in path:
        return ()
    if "embed" in parts:  # (V, d): shard vocab rows
        return ("model", *([None] * (nd - 1)))
    if "lm_head" in parts:  # (d, V): shard vocab columns
        return (*([None] * (nd - 1)), "model")
    if "moe" in parts:  # (L?, E, d, f) expert tables: expert parallelism
        e_dim = nd - 3
        if _divisible(shape, e_dim):
            spec = [None] * nd
            spec[e_dim] = "model"
            return tuple(spec)
        return ()
    if name in _ROW_PARALLEL:  # (..., in, out): shard the contracted input dim
        if _divisible(shape, nd - 2):
            return (*([None] * (nd - 2)), "model", None)
        return ()
    # default column-parallel: shard the output (last) dim
    if _divisible(shape, nd - 1):
        return (*([None] * (nd - 1)), "model")
    return ()


def _vocab_dims(path: str, leaf, spec: tuple) -> tuple:
    """``(dim, size)`` of the vocab dim of an ``embed`` or ``lm_head`` leaf
    that ``spec`` splits (GSPMD pads it where the split does not divide)."""
    parts = path.split("/")
    shape = _shape(leaf)
    dim = 0 if "embed" in parts else len(shape) - 1 if "lm_head" in parts else None
    if dim is None or dim >= len(spec) or spec[dim] is None:
        return ()
    return ((dim, shape[dim]),)


def param_shardings(params: dict, mesh) -> dict:
    """NamedSharding tree mirroring the stacked form of a params tree."""
    def one(path, leaf):
        spec = param_pspec(path, leaf)
        return NamedSharding(mesh, spec, _vocab_dims(path, leaf, spec))

    return _map_with_path(one, stacked(params))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _fold(axes: tuple):
    return axes if len(axes) > 1 else axes[0]


def _with_data_axis(spec: tuple, leaf, mesh) -> tuple:
    """ZeRO-1: fold the data axes into the first replicated dim of a moment."""
    ba = batch_axes(mesh)
    nb = axis_size(mesh, ba)
    shape = _shape(leaf)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for dim, e in enumerate(entries):
        if e is None and shape[dim] % max(nb, 1) == 0:
            entries[dim] = _fold(ba)
            return tuple(entries)
    return spec


def opt_state_shardings(opt_state: OptState, mesh) -> OptState:
    """Shardings for OptState(step, m, v): param rules + ZeRO-1 data folding."""
    def one(path, leaf):
        if len(_shape(leaf)) < 1:
            return replicated(mesh)
        spec = param_pspec(path, leaf)
        # the fold reads the unpadded shape; a vocab dim keeps its pad
        return NamedSharding(mesh, _with_data_axis(spec, leaf, mesh),
                             _vocab_dims(path, leaf, spec))

    def moments(tree):
        return _map_with_path(one, stacked(tree))

    return OptState(step=replicated(mesh), m=moments(opt_state.m), v=moments(opt_state.v))


def batch_shardings(cfg, spec, mesh, batch: dict) -> dict:
    """Model inputs shard their leading (global-batch) dim over the data axes."""
    ba = batch_axes(mesh)
    nb = axis_size(mesh, ba)

    def one(path, leaf):
        shape = _shape(leaf)
        if len(shape) >= 1 and shape[0] % nb == 0:
            return NamedSharding(mesh, (_fold(ba), *([None] * (len(shape) - 1))))
        return replicated(mesh)

    return _map_with_path(one, batch)


# KV-cache leaves and where their sequence (L) axis lives under the cdpim
# dual layout: K column-wise (L last), V / cross-KV row-wise (L second-last).
_KV_L_AXIS = {"k": -1, "k_loc": -1, "v": -2, "v_loc": -2,
              "cross_k": -2, "cross_v": -2}


def cache_shardings(cfg, spec, mesh, cache: dict) -> dict:
    """Decode-cache shardings (``cache``: ``models.model.init_decode_cache``'s
    tree, or ``decode_cache_specs``' shapes).

    Wide-batch decode shards the batch dim (axis 1 of every (nL, B, ...)
    leaf) over the data axes. Batch-1 long-context decode instead folds ALL
    mesh axes into the KV sequence dim: the 500k-token cache is the only
    tensor large enough to occupy the whole mesh.
    """
    ba = batch_axes(mesh)
    nb = axis_size(mesh, ba)
    ndev = mesh.size()
    fold = all_axes(mesh)

    def one(path, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        if nd == 0:
            return replicated(mesh)
        name = path.split("/")[-1]
        wide = spec.global_batch > 1 and spec.global_batch % nb == 0
        if wide and nd >= 3 and shape[1] == spec.global_batch:
            return NamedSharding(mesh, (None, _fold(ba), *([None] * (nd - 2))))
        if name in _KV_L_AXIS and nd >= 4:
            l_ax = nd + _KV_L_AXIS[name]
            if shape[l_ax] % ndev == 0:
                entries = [None] * nd
                entries[l_ax] = _fold(fold)
                return NamedSharding(mesh, tuple(entries))
        return replicated(mesh)

    return _map_with_path(one, cache)


def _local(leaf, spec: tuple, mesh, padded: tuple = ()):
    """``leaf``'s slice on the calling rank: each dim that ``spec`` splits
    over mesh axes narrowed to the rank's equal part along them. A dim of
    ``padded`` that the split does not divide is GSPMD's padded vocab: its
    part is ``ceil(size / n)`` entries, the rows past the full size zeros
    (the last rank holds the pad); any other such dim raises. A split leaf
    is copied once into storage of its own (a column slice is not
    contiguous, and a row slice would keep the full tensor alive), so the
    full tree can be freed; a replicated leaf is returned as it is."""
    if not isinstance(leaf, torch.Tensor):
        return leaf
    pads = dict(padded)
    out = leaf
    for dim, e in enumerate(spec):
        axes = () if e is None else (e,) if isinstance(e, str) else tuple(e)
        if not axes:
            continue
        n = axis_size(mesh, axes)
        size = leaf.shape[dim]
        if size % n and dim not in pads:
            raise ValueError(f"dim {dim} of {tuple(leaf.shape)} does not split over the "
                             f"{n} ranks of {axes}")
        part = -(-size // n)
        lo = axis_index(mesh, axes) * part
        held = max(min(part, size - lo), 0)
        piece = out.narrow(dim, min(lo, size), held)
        if held < part:   # the pad: zeros past the vocab
            shape = list(piece.shape)
            shape[dim] = part - held
            piece = torch.cat([piece, piece.new_zeros(shape)], dim)
        out = piece
    return out if out is leaf else out.clone(memory_format=torch.contiguous_format)


def local_shards(tree: Any, shardings: Any, mesh) -> Any:
    """The calling rank's slices of a full ``tree`` (nested dicts of tensors:
    params, a decode cache, a batch) under ``shardings`` (the matching tree
    of :class:`NamedSharding`, from :func:`param_shardings`,
    :func:`cache_shardings` or :func:`batch_shardings`), by the rank's
    coordinates on ``mesh``. A per-layer list of the params takes the
    stacked tree's shardings, each layer its leaf's spec without the layer
    entry. Works on ``meta`` tensors too (shapes only)."""
    def walk(node, sh, per_layer: bool):
        if isinstance(node, dict):
            return {k: walk(v, sh[k], per_layer) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(layer, sh, True) for layer in node]
        if per_layer:
            return _local(node, sh.spec[1:], mesh)
        return _local(node, sh.spec, mesh, sh.padded)

    return walk(tree, shardings, False)


def _spec_axes(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def full_tree(local: Any, shardings: Any, mesh) -> Any:
    """The inverse of :func:`local_shards` and of the ZeRO-1 form
    (:func:`local_opt_state`): the calling rank's slices gathered back to
    the full tree, each dim that a spec splits all-gathered over its axes
    (every rank of the mesh must call it; ``dist.collectives.all_gather``),
    a padded vocab dim cut back to its size. A per-layer list takes each
    layer's spec without the layer entry; a stacked leaf its whole spec."""
    from repro_torch.dist.collectives import all_gather

    def gather(t, spec, padded=()):
        for dim, e in enumerate(spec):
            if _spec_axes(e):
                t = all_gather(t, mesh, _spec_axes(e), dim=dim)
        for dim, size in padded:
            t = t.narrow(dim, 0, size)
        return t

    def walk(node, sh):
        if isinstance(node, dict):
            return {k: walk(v, sh[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [gather(layer, sh.spec[1:]) for layer in node]
        return gather(node, sh.spec, sh.padded)

    return walk(local, shardings)


@dataclass(frozen=True)
class Zero1Leaf:
    """One stacked leaf of the partitioned train step: the dim its moment
    folds the batch axes into (None: no dim divides, every data rank holds
    the moment whole), the rank's shapes of the stacked param shard and of
    the moment slice, and the leaf's weight in the global gradient norm (one
    over the ranks holding the same slice)."""
    fold: Any
    param_shape: tuple
    moment_shape: tuple
    norm_weight: float


def zero1_plan(cfg, mesh) -> dict[str, Zero1Leaf]:
    """Every stacked leaf of ``cfg``'s params by path, as the partitioned
    train step holds it on ``mesh`` (``param_shardings``,
    ``opt_state_shardings``; the shapes from ``models.model.param_specs``)."""
    params = param_specs(cfg)
    p_sh = param_shardings(params, mesh)
    o_sh = opt_state_shardings(OptState(step=None, m=params, v=params), mesh).m
    ba = batch_axes(mesh)
    out: dict[str, Zero1Leaf] = {}

    def leaf(path, t):
        node_p, node_o = p_sh, o_sh
        for k in path.split("/"):
            node_p, node_o = node_p[k], node_o[k]
        pspec, mspec = node_p.spec, node_o.spec
        fold = next((d for d, e in enumerate(mspec) if _spec_axes(e) == ba), None)
        named = [a for e in mspec for a in _spec_axes(e)]
        holders = mesh.size() // (axis_size(mesh, named) if named else 1)
        out[path] = Zero1Leaf(fold, tuple(_local(t, pspec, mesh, node_p.padded).shape),
                              tuple(_local(t, mspec, mesh, node_o.padded).shape), 1.0 / holders)

    _map_with_path(leaf, params)
    return out


def local_opt_state(cfg, mesh, device) -> OptState:
    """Zero AdamW state in the rank-local ZeRO-1 form: f32 moments in the
    stacked layout, each leaf the rank's slice by its whole
    ``opt_state_shardings`` spec (for a layer-dim fold, its own layers
    only), made at the slices' shapes on ``device`` without a full tree; the
    step an int32 scalar, replicated."""
    plan = zero1_plan(cfg, mesh)

    def zeros():
        return _map_with_path(lambda path, _: torch.zeros(plan[path].moment_shape,
                                                           dtype=torch.float32, device=device),
                              param_specs(cfg))

    return OptState(step=torch.zeros((), dtype=torch.int32, device=device), m=zeros(),
                    v=zeros())

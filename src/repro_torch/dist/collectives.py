"""Collectives over named mesh axes and their count, and gradient compression
(port of ``repro.dist.collectives``, plus the collective layer of the
partitioned program).

**The collective layer.** :func:`all_reduce`, :func:`all_gather` and
:func:`reduce_scatter` act over one named axis of a mesh
(``launch.mesh.make_mesh``), or over a tuple of its axes (the multi-pod
mesh's batch axes ``("pod", "data")``: one group that spans those dims, made
once a mesh, :func:`axis_group`), on whatever backend its group has: NCCL on a
host with one card a rank, ``gloo`` on the CPU and for several ranks on one
card, ``fake`` for a count (its collectives move nothing). Each reduces in
the tensor's own dtype, the activation dtype, as the partitioned JAX program
does. An axis of one rank is no collective: the tensor comes back as it is
and nothing is counted, as GSPMD emits none.

**Gloo staging.** On a ``gloo`` group a CUDA tensor goes through pinned host
memory (:func:`_staged`: copied out, reduced or gathered on the host, copied
back), so every op and dtype takes the path gloo has on the CPU. It is the
two-ranks-on-one-card setting only (NCCL refuses two ranks on one device),
and it is eager: a staged collective cannot be captured in a CUDA graph.

:class:`CollectiveCounter` counts every call by kind for the calling rank:
its calls, and its bytes in the units of
``launch.dryrun.collective_bytes_from_specs`` (the result's bytes; an
all-reduce counted 2x for the ring's reduce and broadcast phases, as the JAX
tool reads an HLO all-reduce). It reads shapes only, so a program counts the
same on ``meta`` over a ``fake`` group as on a live group.

**Under autograd** (the partitioned train step) each collective of the
forward pass has its conjugate in the backward pass, Megatron's pairs, as
``torch.autograd.Function`` s over the same three calls, so that
:class:`CollectiveCounter` counts a backward collective as it counts a
forward one:

* :func:`reduce_from`: the sum of partial results (a row-parallel product,
  the vocab-sharded lookup, the loss's statistics): all-reduce forward,
  identity backward (every rank differentiates the same replicated loss);
* :func:`copy_to`: a replicated input of column-parallel products: identity
  forward, all-reduce of its partial input gradients backward;
* :func:`gather_from`: the K/V columns, or the sequence under sequence
  parallelism: all-gather forward, reduce-scatter backward;
* :func:`scatter_to`: a block's output under sequence parallelism:
  reduce-scatter forward, all-gather backward;
* :func:`split_to`: a replicated tensor cut to the rank's share (the
  embedding's output under sequence parallelism): no collective forward,
  all-gather backward.

Without grad (the decode and prefill programs) each is its plain forward.

:class:`TensorParallel` is the rank's view of the ``model`` axis that the
model code takes: which share of a split dim is its own, and the block's
reductions.

**Gradient compression.** Data-parallel gradient all-reduces dominate
inter-pod traffic at 512 chips. INT8 compression with per-row symmetric
scales (the same quantization the CD-PIM CU applies to weights and
activations, paper §III) cuts those bytes 4x against f32 (2x against bf16).
Used with error feedback (the caller accumulates the residual ``g -
dequantize(quantize(g))`` into the next step) the compression is unbiased
over time. As in the JAX package there is no compressed all-reduce: these
are the two halves of one, on one rank.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import axis_index, axis_size

KINDS = ("all-reduce", "all-gather", "reduce-scatter")
_COUNTERS: list["CollectiveCounter"] = []


class CollectiveCounter:
    """``with CollectiveCounter() as c: ...`` counts the collectives of the
    block; :meth:`totals` gives ``{kind: bytes, ..., "_counts": {kind:
    calls}}`` for the kinds that occurred, the form of
    ``launch.dryrun.collective_bytes_from_specs``."""

    def __init__(self):
        self.bytes = {k: 0.0 for k in KINDS}
        self.calls = {k: 0 for k in KINDS}

    def __enter__(self) -> "CollectiveCounter":
        _COUNTERS.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _COUNTERS.remove(self)
        return False

    def totals(self) -> dict:
        out = {k: self.bytes[k] for k in KINDS if self.calls[k]}
        out["_counts"] = {k: self.calls[k] for k in KINDS if self.calls[k]}
        return out


def _record(kind: str, result: torch.Tensor) -> None:
    nbytes = result.numel() * result.element_size() * (2.0 if kind == "all-reduce" else 1.0)
    for c in _COUNTERS:
        c.bytes[kind] += nbytes
        c.calls[kind] += 1


def _staged(group, t: torch.Tensor) -> bool:
    """Does ``t`` go through pinned host memory on ``group`` (gloo, CUDA)?"""
    import torch.distributed as dist

    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _single(new: str, old: str):
    """A one-tensor collective of ``torch.distributed`` by its current name:
    torch 2.13 renamed ``all_gather_into_tensor``/``reduce_scatter_tensor``
    to ``all_gather_single``/``reduce_scatter_single`` and warns on the old
    names, which are the only ones that torch 2.11 has."""
    import torch.distributed as dist

    return getattr(dist, new, None) or getattr(dist, old)


def _gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    _single("all_gather_single", "all_gather_into_tensor")(out, x, group=group)


def _scatter_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    _single("reduce_scatter_single", "reduce_scatter_tensor")(out, x, group=group)


def _live_axes(mesh, axis) -> tuple[str, ...]:
    """``axis`` (a name or a tuple of names) without the axes of one rank."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    return tuple(a for a in names if axis_size(mesh, a) > 1)


def axis_group(mesh, axis):
    """The process group of one mesh axis, or of a tuple of axes in the
    mesh's dim order: one group spanning those dims, its ranks in the
    order :func:`launch.mesh.axis_index` gives them (the first axis
    outermost). A tuple's groups are made at their first use, by every rank
    of the mesh (``new_subgroups_by_enumeration``), and kept on the mesh;
    they work on a live ``gloo`` or NCCL group and on the ``fake`` one."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    if len(names) == 1:
        return mesh.get_group(names[0])
    groups = getattr(mesh, "_repro_axis_groups", None)
    if groups is None:
        groups = {}
        setattr(mesh, "_repro_axis_groups", groups)
    if names not in groups:
        import torch.distributed as dist

        dims = list(mesh.mesh_dim_names)
        if list(names) != sorted(names, key=dims.index):
            raise ValueError(f"axes {names} are not in the mesh's dim order {dims}")
        inner = [dims.index(a) for a in names]
        outer = [i for i in range(len(dims)) if i not in inner]
        ranks = mesh.mesh.permute(*outer, *inner).reshape(-1, axis_size(mesh, names))
        groups[names], _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    return groups[names]


def all_reduce(x: torch.Tensor, mesh, axis="model", op: str = "sum") -> torch.Tensor:
    """``x`` summed (``op="max"``: its maximum) over the ranks of ``axis``
    (a name or a tuple of names), in place (``x`` is returned)."""
    import torch.distributed as dist

    axes = _live_axes(mesh, axis)
    if not axes:
        return x
    _record("all-reduce", x)
    group = axis_group(mesh, axes)
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if _staged(group, x):
        h = _host(x)
        dist.all_reduce(h, op=rop, group=group)
        return x.copy_(h)
    dist.all_reduce(x, op=rop, group=group)
    return x


def all_gather(x: torch.Tensor, mesh, axis="model", dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in their order on
    ``axis``."""
    axes = _live_axes(mesh, axis)
    if not axes:
        return x
    n = axis_size(mesh, axes)
    dim = dim % x.dim()
    x = x.contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    _record("all-gather", out)
    group = axis_group(mesh, axes)
    if _staged(group, x):
        h = torch.empty(out.shape, dtype=x.dtype, pin_memory=True)
        _gather_into(h, _host(x), group)
        out.copy_(h)
    else:
        _gather_into(out, x, group)
    # (n * x0, ...) -> (n, x0, ...) -> n just before ``dim``, merged into it
    return out.view(n, *x.shape).movedim(0, dim).flatten(dim, dim + 1)


def reduce_scatter(x: torch.Tensor, mesh, axis="model", dim: int = 0) -> torch.Tensor:
    """``x`` summed over the ranks of ``axis``, and this rank's share of the
    sum along ``dim`` (the rank's index-th of ``axis``'s equal parts)."""
    axes = _live_axes(mesh, axis)
    if not axes:
        return x
    n = axis_size(mesh, axes)
    dim = dim % x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks of {axes}")
    xs = x.movedim(dim, 0).contiguous()
    out = torch.empty((xs.shape[0] // n, *xs.shape[1:]), dtype=x.dtype, device=x.device)
    _record("reduce-scatter", out)
    group = axis_group(mesh, axes)
    if _staged(group, x):
        h = torch.empty(out.shape, dtype=x.dtype, pin_memory=True)
        _scatter_into(h, _host(xs), group)
        out.copy_(h)
    else:
        _scatter_into(out, xs, group)
    return out.movedim(0, dim)


def _share(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """The rank's equal share of ``x`` along ``dim`` over ``axis``."""
    n = axis_size(mesh, axis)
    c = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, axis) * c, c)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mark_dirty(x)
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh, ctx.axis), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _share(x, mesh, axis, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def _tracked(x: torch.Tensor, mesh, axis) -> bool:
    """Does ``x`` take the autograd form: grad on, ``x`` in the graph, and
    ``axis`` more than one rank?"""
    return torch.is_grad_enabled() and x.requires_grad and bool(_live_axes(mesh, axis))


def reduce_from(x: torch.Tensor, mesh, axis="model") -> torch.Tensor:
    """The sum of the ranks' partial ``x`` (:func:`all_reduce`, in place);
    its gradient passes unchanged."""
    return _ReduceFrom.apply(x, mesh, axis) if _tracked(x, mesh, axis) else all_reduce(
        x, mesh, axis)


def copy_to(x: torch.Tensor, mesh, axis="model") -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``axis`` (an all-reduce)."""
    return _CopyTo.apply(x, mesh, axis) if _tracked(x, mesh, axis) else x


def gather_from(x: torch.Tensor, mesh, axis="model", dim: int = 0) -> torch.Tensor:
    """:func:`all_gather`; its gradient reduce-scattered back to the rank's
    share."""
    return _GatherFrom.apply(x, mesh, axis, dim) if _tracked(x, mesh, axis) else all_gather(
        x, mesh, axis, dim)


def scatter_to(x: torch.Tensor, mesh, axis="model", dim: int = 0) -> torch.Tensor:
    """:func:`reduce_scatter`; its gradient all-gathered."""
    return _ScatterTo.apply(x, mesh, axis, dim) if _tracked(x, mesh, axis) else \
        reduce_scatter(x, mesh, axis, dim)


def split_to(x: torch.Tensor, mesh, axis="model", dim: int = 0) -> torch.Tensor:
    """The rank's share of a replicated ``x`` along ``dim`` (a view, no
    collective); its gradient all-gathered, so that every rank holds the
    whole gradient of ``x``."""
    if not _live_axes(mesh, axis):
        return x
    return _SplitTo.apply(x, mesh, axis, dim) if _tracked(x, mesh, axis) else _share(
        x, mesh, axis, dim)


class TensorParallel:
    """The calling rank's share of a mesh's ``model`` axis, for the model
    code of the partitioned program: ``size`` ranks, this one at ``index``.
    With ``seq`` the activations between blocks shard their sequence (dim 1)
    over ``model`` (sequence parallelism): a block gathers its normed input
    and scatters its reduced output. Every collective takes its autograd
    form where grad flows (the train step)."""

    def __init__(self, mesh, seq: bool = False):
        self.mesh = mesh
        self.size = axis_size(mesh, "model")
        self.index = axis_index(mesh, "model")
        self.seq = seq and self.size > 1

    def offset(self, n_local: int) -> int:
        """Where this rank's ``n_local`` entries of a split dim start."""
        return self.index * n_local

    def local_seq(self, x: torch.Tensor) -> torch.Tensor:
        """Under ``seq``, this rank's share of ``x``'s sequence (its gradient
        gathered over the sequence); else ``x``."""
        return split_to(x, self.mesh, "model", dim=1) if self.seq else x

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """Under ``seq``, the whole sequence of ``x`` (an all-gather); else ``x``."""
        return gather_from(x, self.mesh, "model", dim=1) if self.seq else x

    def column_input(self, h: torch.Tensor, split: bool) -> torch.Tensor:
        """The input of column-parallel products (``split``: the rank holds a
        share of their columns): under ``seq`` its whole sequence; else ``h``,
        whose gradient, a partial sum where the products are split, is summed
        over ``model``."""
        if self.seq:
            return self.gather_seq(h)
        return copy_to(h, self.mesh, "model") if split else h

    def reduce(self, y: torch.Tensor, split: bool) -> torch.Tensor:
        """A block's output ``y``: this rank's partial sum where its weight
        was split over ``model`` (``split``), which is summed over the axis
        (an all-reduce; under ``seq`` a reduce-scatter over the sequence);
        where it was not, the whole output (under ``seq`` its share)."""
        if self.seq:
            return scatter_to(y, self.mesh, "model", dim=1) if split else self.local_seq(y)
        return reduce_from(y, self.mesh, "model") if split else y


def quantize_grad(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row INT8 quantization of a gradient tensor.

    Returns ``(q_int8, scale_f32)`` with ``scale`` keeping the reduced axis
    (keepdims) so :func:`dequantize_grad` is a plain broadcast multiply.
    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    gf = g.float()
    amax = gf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.round(gf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_grad(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_grad` (exact up to the rounding step)."""
    return q.float() * scale

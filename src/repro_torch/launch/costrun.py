"""Cost count of one (arch × shape) cell for the roofline table (port of
``repro.launch.costrun``).

The JAX package reads XLA's cost analysis of the compiled program. The port
has no compiler, so :class:`CostCounter` counts the PyTorch calls the cell
makes as they run, eagerly, on the ``meta`` device (shapes only, no storage,
no arithmetic), on the CPU or on the card, and gives the same count on each:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count (the matmul
  family: mm, bmm, addmm, convolution, attention) plus the kernels' work;
* ``bytes``: every call's tensor inputs read once and outputs written once.
  Views move nothing. An indexed read (an embedding lookup, ``gather``) counts
  the rows it reads, not its whole source; an in-place or indexed write into
  a cache (the ``index_put_`` of ``core.kv_mapping.append_layer``, the
  ``copy_`` of ``store_block``) counts the bytes written, not the size of the
  cache;
* ``transcendentals``: the elements that exp, log, tanh, erf, sigmoid,
  softmax and their kin produce (:data:`TRANSCENDENTAL_OPS`);
* ``kernels``: each kernel op's calls and reported work
  (``kernels.work.kernel_scope``). Inside a kernel op only its own work
  counts, never the PyTorch calls of its plain version.

Two deliberate differences from the JAX package's count:

* **Eager counting runs every loop step.** XLA's cost analysis counts a
  while-loop body once whatever its trip count, which the JAX tool repairs by
  differential measurement at two reduced depths and analytic corrections
  for the inner token scans (``rwkv_wkv_correction`` and
  ``ssd_chunk_correction`` in ``src/repro/launch/costrun.py``). Here every
  scan step of the reduced-depth variants runs, so their fit to the full
  depth (:func:`fit_depth`, the same least squares) is exact and needs no
  correction.
* **Per device is the whole program over the mesh's device count.** The
  count is the unpartitioned program's, divided by the production mesh's
  256 ranks, for every cell: the partitioned program (``mesh=``) covers
  only some cells (the dense family's, gemma2-27b's, internvl2-2b's and
  seamless-m4t-large-v2's decode, prefill and train cells), and of those
  the dry run reads only its collectives (``collectives_source``).

A decode cell's attention counts the cache's capacity (every slot live), as
a compiler's static count does: its lanes are full in the cell anyway.

Usage: ``PYTHONPATH=src python -m repro_torch.launch.costrun [--arch A]
[--shape S]`` (meta device, no card; writes ``results/torch/costs.json``).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, get_config, input_specs, list_archs, shape_applicable
from repro_torch.dist import sharding as shard_lib
from repro_torch.launch.partitioned import shard_params
from repro_torch.models import model as M
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import train_step, train_step_

N_DEVICES = 256          # single-pod roofline
AUDIO_CROSS_LEN = 4096   # stub audio memory length for decode shapes

_aten = torch.ops.aten
TRANSCENDENTAL_OPS = {_aten.exp, _aten.exp2, _aten.expm1, _aten.log, _aten.log1p, _aten.log2,
                      _aten.tanh, _aten.erf, _aten.sigmoid, _aten._softmax,
                      _aten._log_softmax, _aten.rsqrt, _aten.sin, _aten.cos, _aten.silu,
                      _aten.exp_, _aten.sigmoid_, _aten.tanh_}
# calls that allocate or alias without moving a byte
_FREE_OPS = {_aten.empty, _aten.empty_strided, _aten.new_empty, _aten.new_empty_strided,
             _aten.empty_like, _aten._unsafe_view, _aten.lift_fresh, _aten.detach,
             _aten.alias, _aten._local_scalar_dense}
# indexed reads and their source argument, which counts the rows read
_GATHER_SOURCE = {_aten.index: "self", _aten.embedding: "weight", _aten.gather: "self",
                  _aten.index_select: "self"}
# in-place calls that overwrite their target without reading it
_OVERWRITE_OPS = {_aten.copy_, _aten.index_put_, _aten.zero_, _aten.fill_,
                  _aten.index_copy_, _aten.masked_fill_}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _index_put_written(target: torch.Tensor, indices) -> int:
    """Elements an ``index_put_`` writes: the broadcast index shape times the
    dims no index covers."""
    shapes = [tuple(i.shape) for i in indices if i is not None]
    n = int(np.prod(torch.broadcast_shapes(*shapes))) if shapes else 1
    covered = {d for d, i in enumerate(indices) if i is not None}
    rest = [s for d, s in enumerate(target.shape) if d not in covered]
    return n * int(np.prod(rest)) if rest else n


@functools.lru_cache(maxsize=None)
def _signature(func) -> tuple:
    """(argument names, the arguments it writes) of an aten overload."""
    args = func._schema.arguments
    return (tuple(a.name for a in args),
            frozenset(a.name for a in args if a.alias_info is not None and a.alias_info.is_write))


class _ByteCounter(TorchDispatchMode):
    """Counts the bytes and transcendentals of every call it sees, and takes
    the kernels' reports (``kernel_work``) for its :class:`CostCounter`."""

    def __init__(self, owner: "CostCounter"):
        super().__init__()
        self.owner = owner

    def kernel_work(self, name: str, nbytes: int, ops: int) -> None:
        k = self.owner.kernels.setdefault(name, {"calls": 0, "bytes": 0, "ops": 0})
        k["calls"] += 1
        k["bytes"] += nbytes
        k["ops"] += ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if func.is_view or packet in _FREE_OPS:
            return out
        owner = self.owner
        if packet in TRANSCENDENTAL_OPS:
            owner.transcendentals += sum(t.numel() for t in _tensors(out))
        names, written = _signature(func)
        values = dict(zip(names, args))
        values.update(kwargs)
        nbytes = 0
        source = _GATHER_SOURCE.get(packet)
        for name, v in values.items():
            if name == source:
                nbytes += sum(_nbytes(t) for t in _tensors(out))   # the rows read
            elif name in written:
                if packet is _aten.index_put_:
                    n = _index_put_written(v, values["indices"])
                    nbytes += n * v.element_size() * (2 if values.get("accumulate") else 1)
                else:
                    reads = packet not in _OVERWRITE_OPS and not name.startswith("out")
                    nbytes += _nbytes(v) * (2 if reads else 1)
            else:
                nbytes += sum(_nbytes(t) for t in _tensors(v))
        if not written:
            nbytes += sum(_nbytes(t) for t in _tensors(out))
        owner.bytes += nbytes
        return out


class CostCounter:
    """``with CostCounter() as c: ...`` counts the PyTorch calls and kernel
    ops of the block: :meth:`totals` gives ``flops``, ``bytes`` and
    ``transcendentals`` (the kernels' work included) and ``kernels`` each
    kernel op's calls, bytes and operations. The count depends on shapes
    only, so a block counts the same on ``meta``, on the CPU and on the card."""

    def __init__(self):
        self.bytes = 0
        self.transcendentals = 0
        self.kernels: dict[str, dict] = {}
        self._flops = FlopCounterMode(display=False)
        self._modes = (self._flops, _ByteCounter(self))

    def __enter__(self) -> "CostCounter":
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        for m in reversed(self._modes):
            m.__exit__(*exc)
        return False

    def totals(self) -> dict:
        kernel_bytes = sum(k["bytes"] for k in self.kernels.values())
        kernel_ops = sum(k["ops"] for k in self.kernels.values())
        return {"flops": self._flops.get_total_flops() + kernel_ops,
                "bytes": self.bytes + kernel_bytes,
                "transcendentals": self.transcendentals,
                "kernels": {n: dict(k) for n, k in sorted(self.kernels.items())}}


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------


def _materialize(specs: dict, device) -> dict:
    """Model inputs (``configs.input_specs``' meta stand-ins) on ``device``:
    zeros, or the stand-ins themselves on ``meta``."""
    if torch.device(device).type == "meta":
        return dict(specs)
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device) for k, v in specs.items()}


def decode_cell(cfg, batch: int, seq_len: int, params: dict, device="meta", mesh=None):
    """(step, cache) of a decode cell: one token a lane against a contiguous
    cache of ``seq_len`` slots (the audio decoder's encoder memory a stub of
    :data:`AUDIO_CROSS_LEN` frames), each lane's fill ``pos`` a (batch,)
    vector at ``seq_len - 1``, so every lane is full after the step.
    ``step()`` runs ``models.model.decode_step`` (the cache is written in
    place, ``pos`` is not advanced: each call is the same step); with
    ``mesh`` the rank's partitioned step (``params`` its shards, the cache
    its lanes of every KV head)."""
    src = AUDIO_CROSS_LEN if cfg.family == "audio" else 0
    cache = M.init_decode_cache(cfg, batch, seq_len, device=device, src_len=src)
    cache["pos"] = torch.full((batch,), seq_len - 1, dtype=torch.int32, device=device)
    tokens = torch.zeros((batch, 1), dtype=torch.int32, device=device)

    def step():
        return M.decode_step(params, cache, tokens, cfg, mesh=mesh)

    return step, cache


def build_cell(cfg, shape: str, device="meta", batch=None, mesh=None):
    """A zero-argument callable that runs the cell's step once: train is
    ``train_step`` at ``accum`` 1 with AdamW (backward included); prefill is
    ``models.model.prefill`` into a cache of ``seq_len + prefix + 64``;
    decode is :func:`decode_cell`. ``batch`` overrides the shape's global
    batch (a data group's share); ``mesh`` makes a decode cell the rank's
    partitioned step over its shards of the params, and a train cell the
    rank's in-place partitioned ``train_step_`` at the dry run's
    ``TRAIN_ACCUM`` (its shards of the params, its ZeRO-1 slices of zero
    moments, ``batch`` its rows; the
    callable's ``params``, ``batch`` and ``opt_state`` attributes hold them)."""
    spec = SHAPES[shape]
    if batch is not None:
        spec = dataclasses.replace(spec, global_batch=batch)
    params = M.init_params(cfg, None if torch.device(device).type == "meta" else
                           torch.Generator(device=device).manual_seed(0), device=device)
    if spec.kind == "decode":
        if mesh is not None:
            params = shard_params(params, mesh)
        return decode_cell(cfg, spec.global_batch, spec.seq_len, params, device, mesh)[0]
    inputs = _materialize(input_specs(cfg, spec), device)
    if spec.kind == "train" and mesh is not None:
        from repro_torch.launch.dryrun import TRAIN_ACCUM

        params = shard_params(params, mesh)
        opt = shard_lib.local_opt_state(cfg, mesh, device)

        def step():
            return train_step_(params, opt, inputs, cfg, AdamWConfig(), TRAIN_ACCUM,
                               mesh=mesh)

        step.params, step.batch, step.opt_state = params, inputs, opt
        return step
    if spec.kind == "train":
        opt = init_opt_state(params)
        return lambda: train_step(params, opt, inputs, cfg, AdamWConfig(), 1)
    max_len = spec.seq_len + cfg.n_prefix_tokens + 64
    tokens = inputs.pop("tokens")
    return lambda: M.prefill(params, tokens, cfg, max_len, **inputs)


def count(fn) -> dict:
    """:class:`CostCounter` totals of one call of ``fn`` (under ``no_grad``
    unless ``fn`` enables grad itself, as ``train_step`` does)."""
    with torch.no_grad(), CostCounter() as c:
        fn()
    return c.totals()


def _reduced_cfgs(cfg, spec):
    """Two structure-preserving reduced-depth variants + their depth counts.

    Returns list of (cfg_variant, depth_vector) where depth_vector is the
    tuple of structural counts the linear cost model extrapolates over.
    """
    base = cfg.replace(scan_layers=False, remat=cfg.remat)
    if cfg.family == "hybrid":
        # 2-D depth: (groups of [attn_every mambas + shared attn], tail mambas)
        g = cfg.attn_every
        return ([(base.replace(n_layers=g), (1, 0)),
                 (base.replace(n_layers=2 * g), (2, 0)),
                 (base.replace(n_layers=g + 1), (1, 1))],
                (cfg.n_layers // g, cfg.n_layers % g), {})
    if cfg.family == "audio":
        return ([(base.replace(n_encoder_layers=1, n_layers=1), (1, 1)),
                 (base.replace(n_encoder_layers=2, n_layers=1), (2, 1)),
                 (base.replace(n_encoder_layers=1, n_layers=2), (1, 2))],
                (cfg.n_encoder_layers, cfg.n_layers), {})
    if cfg.local_global_pattern:
        # keep the local/global alternation: use 2 and 4 layers
        return ([(base.replace(n_layers=2), (2,)),
                 (base.replace(n_layers=4), (4,))],
                (cfg.n_layers,), {})
    return ([(base.replace(n_layers=1), (1,)),
             (base.replace(n_layers=2), (2,))],
            (cfg.n_layers,), {})


def fit_depth(cfg, shape: str) -> dict:
    """The whole step's count at full depth from the reduced-depth variants
    (:func:`_reduced_cfgs`), by the JAX tool's least squares over the depth
    vectors: ``flops``, ``bytes``, ``transcendentals`` and each kernel's
    ``calls``/``bytes``/``ops`` at full depth, with ``<key>_per_layer`` and
    ``<key>_fixed`` for the first three. Every layer of a cell counts the
    same, so the fit is exact (up to float rounding; the tests hold it to a
    full-depth count): it only spares counting every layer, which for
    rwkv6's per-token scan at 32k tokens would take an hour of host time."""
    spec = SHAPES[shape]
    variants, full_depth, _ = _reduced_cfgs(cfg, spec)
    meas = [(depth, count(build_cell(cv, shape))) for cv, depth in variants]
    rows = np.array([[1.0, *d] for d, _ in meas])

    def fit(values):
        coef, *_ = np.linalg.lstsq(rows, np.array(values, dtype=float), rcond=None)
        return coef, float(coef[0] + sum(c * n for c, n in zip(coef[1:], full_depth)))

    out: dict = {}
    for k in ("flops", "bytes", "transcendentals"):
        coef, out[k] = fit([m[k] for _, m in meas])
        out[f"{k}_per_layer"] = [float(c) for c in coef[1:]]
        out[f"{k}_fixed"] = float(coef[0])
    names = sorted({n for _, m in meas for n in m["kernels"]})
    out["kernels"] = {n: {f: round(fit([m["kernels"].get(n, {}).get(f, 0) for _, m in meas])[1])
                          for f in ("calls", "bytes", "ops")} for n in names}
    return out


@functools.lru_cache(maxsize=None)
def cell_count(arch: str, shape: str, overrides: tuple = ()) -> dict:
    """:func:`fit_depth` of a registered cell (``overrides``: sorted (key,
    value) pairs for ``ModelConfig.replace``), kept for the process: the dry
    run's two meshes and the cost count share it."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**dict(overrides))
    return fit_depth(cfg, shape)


def run_cell(arch: str, shape: str, overrides: dict | None = None) -> dict:
    """Per-device counts of the cell (:func:`cell_count` over :data:`N_DEVICES`)
    with the JAX result's keys, plus ``kernels`` (whole-step work)."""
    from repro_torch.launch import dryrun

    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    ok, why = shape_applicable(cfg, SHAPES[shape])
    if not ok:
        return {"status": "skipped", "reason": why}
    t0 = time.time()
    try:
        whole = cell_count(arch, shape, tuple(sorted((overrides or {}).items())))
        result: dict = {}
        for k in ("flops", "bytes", "transcendentals"):
            result[k] = whole[k] / N_DEVICES
            result[f"{k}_per_layer"] = [c / N_DEVICES for c in whole[f"{k}_per_layer"]]
            result[f"{k}_fixed"] = whole[f"{k}_fixed"] / N_DEVICES
        result["kernels"] = whole["kernels"]
        result["collectives"], result["collectives_source"] = dryrun.collectives_for(cfg, shape)
        result["n_devices"] = N_DEVICES
        result["status"] = "ok"
        result["measure_s"] = round(time.time() - t0, 1)
        return result
    except Exception as e:
        return {"status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-1500:]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="results/torch/costs.json")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    for a in archs:
        for s in shapes:
            key = f"{a}|{s}"
            if results.get(key, {}).get("status") in ("ok", "skipped"):
                print(f"[skip cached] {key}")
                continue
            print(f"[costrun] {key} ...", flush=True)
            results[key] = run_cell(a, s)
            st = results[key]["status"]
            print(f"  -> {st} flops={results[key].get('flops'):.3e}"
                  if st == "ok" else f"  -> {st}: {results[key].get('reason', results[key].get('error'))}",
                  flush=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()

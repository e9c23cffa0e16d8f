"""Dry run of every (arch × shape × mesh) cell (port of ``repro.launch.dryrun``).

The JAX tool lowers and compiles each cell for 512 forced host devices and
reads the compiled program's memory, cost and collectives. The port has no
compiler, so a dry run builds the cell on the ``meta`` device (shapes only)
over the production mesh of a ``fake`` process group
(``launch.mesh.production_mesh_for_counting``), traces one step of it under
``launch.costrun.CostCounter`` at the reduced depths of the cost count
(``costrun.cell_count``: exact at full depth, and shared by both meshes) and
reads:

* ``memory``: ``argument_bytes`` and ``output_bytes`` per rank, from the
  sharding specs (``dist.sharding``) of the stacked params, the optimizer
  state, the batch and the cache: each leaf's bytes over the sizes of the mesh
  axes in its spec; ``alias_bytes`` what the outputs reuse of the donated
  arguments (train: params and optimizer state; decode: the cache);
  ``temp_bytes`` is null, there is no compiler to ask;
* ``cost``: the count of the whole step at full depth over the mesh's
  device count;
* ``collectives``: for the cells the partitioned program covers (the dense
  archs, gemma2-27b included, internvl2-2b and seamless-m4t-large-v2 at
  ``decode_32k``, ``prefill_32k`` and ``train_4k``: float linears,
  contiguous lanes, a batch that splits over the data axes),
  what rank 0's share of that program (``models.model.decode_step``/
  ``prefill`` or ``train.train_step.train_step`` with ``mesh=``, full depth;
  the train step at the JAX dry run's :data:`TRAIN_ACCUM` microbatches, each
  with its backward and, under ``remat``, its recompute) moves, counted by
  ``dist.collectives.CollectiveCounter`` on ``meta`` over the fake group
  (:func:`collective_bytes_from_program`); for every other cell
  :func:`collective_bytes_from_specs`, what the specs imply.
  ``collectives_source`` says which: ``"program"`` or ``"specs"``.

Usage: ``PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
[--shape S] [--multi-pod | --all]`` (meta device, no card; writes
``results/torch/dryrun.json``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import SHAPES, get_config, input_specs, list_archs, shape_applicable
from repro_torch.dist import sharding as shard_lib
from repro_torch.dist.collectives import CollectiveCounter
from repro_torch.launch.mesh import axis_size, batch_axes, production_mesh_for_counting
from repro_torch.launch.partitioned import shard_params
from repro_torch.models import model as M
from repro_torch.train.optimizer import AdamWConfig, init_opt_state

AUDIO_CROSS_LEN = 4096  # stub audio memory length for decode shapes
TRAIN_ACCUM = 4         # microbatches per train step, as the JAX dry run's


def _leaves_with_specs(tree: dict, shardings: dict) -> list:
    """(leaf, spec) pairs of a tree of tensors or ``(shape, dtype)`` pairs and
    its matching tree of ``NamedSharding``s."""
    out = []

    def walk(t, s):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k])
        else:
            out.append((t, s.spec))

    walk(tree, shardings)
    return out


def _bytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    shape, dtype = leaf
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _spec_axes(entry) -> tuple:
    return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))


def per_rank_bytes(pairs, mesh) -> int:
    """Bytes one rank holds of ``(leaf, spec)`` pairs: each leaf's bytes over
    the sizes of the mesh axes its spec names."""
    total = 0
    for leaf, spec in pairs:
        axes = [a for e in spec for a in _spec_axes(e)]
        total += _bytes(leaf) // (axis_size(mesh, axes) if axes else 1)
    return total


def _cache_specs(cfg, spec) -> dict:
    src = AUDIO_CROSS_LEN if cfg.family == "audio" else 0
    if spec.kind == "decode":
        return M.init_decode_cache(cfg, spec.global_batch, spec.seq_len, device="meta",
                                   src_len=src)
    max_len = spec.seq_len + cfg.n_prefix_tokens + 64
    return M.init_decode_cache(cfg, spec.global_batch, max_len, device="meta",
                               src_len=spec.seq_len if cfg.family == "audio" else 0)


def memory_from_specs(cfg, shape: str, mesh) -> dict:
    """Per-rank argument, output and aliased bytes of the cell's step under
    the sharding rules (the JAX ``memory_analysis`` keys; no temporaries)."""
    spec = SHAPES[shape]
    params = M.param_specs(cfg)
    p_pairs = _leaves_with_specs(params, shard_lib.param_shardings(params, mesh))
    batch = input_specs(cfg, spec)
    b_pairs = _leaves_with_specs(batch, shard_lib.batch_shardings(cfg, spec, mesh, batch))
    ba = batch_axes(mesh)
    vocab_ax = "model" if cfg.vocab_size % mesh.size(mesh.mesh_dim_names.index("model")) == 0 \
        else None
    if spec.kind == "train":
        opt = init_opt_state(params)
        o_sh = shard_lib.opt_state_shardings(opt, mesh)
        o_pairs = (_leaves_with_specs(opt.m, o_sh.m) + _leaves_with_specs(opt.v, o_sh.v)
                   + [(opt.step, ())])
        state = per_rank_bytes(p_pairs + o_pairs, mesh)
        args = state + per_rank_bytes(b_pairs, mesh)
        outs, alias = state + 3 * 4, state          # params', opt', three f32 stats
    else:
        cache = _cache_specs(cfg, spec)
        c_pairs = _leaves_with_specs(cache, shard_lib.cache_shardings(cfg, spec, mesh, cache))
        c_bytes = per_rank_bytes(c_pairs, mesh)
        rows = (ba if len(ba) > 1 else ba[0]) \
            if spec.kind == "prefill" or spec.global_batch % axis_size(mesh, ba) == 0 else None
        logits = torch.empty((spec.global_batch, 1, cfg.vocab_size), dtype=torch.float32,
                             device="meta")
        l_bytes = per_rank_bytes([(logits, (rows, None, vocab_ax))], mesh)
        p_bytes = per_rank_bytes(p_pairs, mesh)
        if spec.kind == "prefill":
            args, alias = p_bytes + per_rank_bytes(b_pairs, mesh), 0
        else:
            args, alias = p_bytes + c_bytes + per_rank_bytes(b_pairs, mesh), c_bytes
        outs = l_bytes + c_bytes
    return {"output_bytes": outs, "temp_bytes": None, "argument_bytes": args,
            "alias_bytes": alias, "generated_code_bytes": None}


def collective_bytes_from_specs(cfg, shape: str, mesh) -> dict:
    """Per-device bytes each collective kind would move for one step, as the
    sharding specs imply it: a model of the partitioned program, not a
    reading of one (the port compiles none). The specs are Megatron tensor
    parallelism over ``model`` (``dist.sharding``), so weights stay sharded
    and activations move. With ``b`` a rank's share of the batch (its batch
    spec's axes), ``T`` the tokens each lane runs through a layer stack (the
    decoder's, with a VLM's prefix; the audio encoder's frames for its stack)
    and ``a`` the activation dtype's size:

    * ``all-reduce``, each counted 2x for the ring's reduce and broadcast
      phases (as the JAX tool counts one): every row-parallel weight (sharded
      on its contracted dim) reduces its output, ``b·T·out·a``, once a layer
      that applies it (a hybrid's shared block once every ``attn_every``
      layers); the vocab-sharded embedding's lookup, ``b·T·d·a``. A train
      step repeats the blocks' reductions in the backward pass (the conjugate
      reduction of each column-parallel input's gradient) and again in the
      remat recompute, reduces the LM head's input gradient ``b·T·d·a`` and
      the loss's two f32 statistics a token over the vocab shards, and
      reduces every gradient over the batch axes (its per-rank bytes).
    * ``all-to-all``: expert-sharded MoE tables send each routed token copy
      to its expert and back, ``2·b·T·top_k·capacity_factor·d·a`` a layer
      (times the train passes).
    * ``all-gather``: any other leaf sharded over ``model`` on a dim that no
      product contracts or produces (the MoE router's layer dim) is gathered
      whole once a step.

    A logits output stays vocab-sharded (its spec), and a decode over a
    sequence-sharded cache (``long_500k``'s batch of one) merges the heads'
    partial softmax sums: a few KB a layer, left out.

    What the partitioned program adds where it covers a cell
    (:func:`collective_bytes_from_program`): one all-gather a layer of the
    new tokens' K/V projections over ``model``, ``2·b·T·Hkv·hd·a`` (the
    rank's K/V columns are a share that may split a head, and RoPE and the
    replicated cache need every head), which this model leaves out."""
    spec = SHAPES[shape]
    params = M.param_specs(cfg)
    leaves = []
    shard_lib._map_with_path(
        lambda path, leaf: leaves.append((path, leaf, shard_lib.param_pspec(path, leaf))), params)
    batch = input_specs(cfg, spec)
    b_spec = shard_lib.batch_shardings(cfg, spec, mesh, batch)["tokens"].spec
    b = spec.global_batch // axis_size(mesh, _spec_axes(b_spec[0] if b_spec else None))
    t_dec = batch["tokens"].shape[1] + (batch["prefix_embeds"].shape[1]
                                        if "prefix_embeds" in batch else 0)
    t_enc = batch["src_frames"].shape[1] if "src_frames" in batch else 0
    a = getattr(torch, cfg.dtype).itemsize
    passes = (2 + int(cfg.remat)) if spec.kind == "train" else 1
    out = {"all-reduce": 0.0, "all-to-all": 0.0, "all-gather": 0.0}
    counts = {k: 0 for k in out}
    for path, leaf, s in leaves:
        if "model" not in s:
            continue
        parts = path.split("/")
        shape_ = tuple(leaf.shape)
        dim = s.index("model")
        apps = shape_[0] if parts[0] in M.STACKED else 1
        if parts[0] == "shared_attn":
            apps = cfg.n_layers // cfg.attn_every
        tokens = b * (t_enc if parts[0] == "enc_layers" else t_dec)
        if parts[0] == "embed":
            out["all-reduce"] += 2.0 * b * batch["tokens"].shape[1] * cfg.d_model * a
            counts["all-reduce"] += 1
        elif "moe" in parts and parts[-1] == "w_down":
            out["all-to-all"] += (passes * apps * 2.0 * tokens * cfg.top_k
                                  * cfg.moe_capacity_factor * cfg.d_model * a)
            counts["all-to-all"] += passes * apps * 2
        elif dim == len(shape_) - 2 and "moe" not in parts:
            out["all-reduce"] += passes * apps * 2.0 * tokens * shape_[-1] * a
            counts["all-reduce"] += passes * apps
        elif dim < len(shape_) - 2 and "moe" in parts and parts[-1] == "router":
            out["all-gather"] += float(_bytes(leaf))
            counts["all-gather"] += 1
    if spec.kind == "train":
        out["all-reduce"] += 2.0 * b * t_dec * (cfg.d_model * a + 2 * 4)   # the head
        out["all-reduce"] += 2.0 * per_rank_bytes([(l, s) for _, l, s in leaves], mesh)
        counts["all-reduce"] += 2 + len(leaves)
    out = {k: v for k, v in out.items() if counts[k]}
    out["_counts"] = {k: v for k, v in counts.items() if v}
    return out


def program_covers(cfg, shape: str, mesh) -> bool:
    """Does the partitioned program run the cell on ``mesh``: a shape whose
    batch splits over the data axes (the wide-batch cache spec; a train
    shape's rank rows over :data:`TRAIN_ACCUM` microbatches too), for a
    config ``models.model.check_partitioned`` takes (a train shape:
    ``models.model.train_parallel``)?"""
    spec = SHAPES[shape]
    nb = axis_size(mesh, batch_axes(mesh))
    if spec.global_batch <= 1 or spec.global_batch % nb:
        return False
    if spec.kind == "train" and (spec.global_batch // nb) % TRAIN_ACCUM:
        return False
    try:
        if spec.kind == "train":
            M.train_parallel(cfg, mesh, M.stack_len(cfg, input_specs(cfg, spec)))
        else:
            M.check_partitioned(cfg, mesh)
    except ValueError:
        return False
    return True


def collective_bytes_from_program(cfg, shape: str, mesh) -> dict:
    """Per-rank bytes and calls of each collective kind in one step of the
    partitioned program (a cell :func:`program_covers`), read from the
    program itself: rank 0's shards of the params (full depth), its rows of
    the batch (a vlm's ``prefix_embeds``, audio's ``src_frames`` beside the
    tokens) and, for decode, its lanes of a cache of ``seq_len`` slots
    (audio's encoder memory :data:`AUDIO_CROSS_LEN` frames), for train its
    ZeRO-1 slices of the moments and :data:`TRAIN_ACCUM` microbatches, run
    on ``meta`` under ``CollectiveCounter`` (the form of
    :func:`collective_bytes_from_specs`, ``_counts`` included)."""
    from repro_torch.train.train_step import train_step

    spec = SHAPES[shape]
    params = shard_params(M.init_params(cfg, None, device="meta"), mesh)
    batch = input_specs(cfg, spec)
    local = shard_lib.local_shards(batch, shard_lib.batch_shardings(cfg, spec, mesh, batch),
                                   mesh)
    tokens = local["tokens"]
    b = tokens.shape[0]
    if spec.kind == "train":
        state = shard_lib.local_opt_state(cfg, mesh, "meta")
        with CollectiveCounter() as counter:
            train_step(params, state, local, cfg, AdamWConfig(), TRAIN_ACCUM, mesh=mesh)
        return counter.totals()
    with torch.no_grad(), CollectiveCounter() as counter:
        if spec.kind == "decode":
            cache = M.init_decode_cache(cfg, b, spec.seq_len, device="meta",
                                        src_len=AUDIO_CROSS_LEN if cfg.family == "audio" else 0)
            cache["pos"] = torch.full((b,), spec.seq_len - 1, dtype=torch.int32,
                                      device="meta")
            M.decode_step(params, cache, tokens, cfg, mesh=mesh)
        else:
            M.prefill(params, tokens, cfg, spec.seq_len + cfg.n_prefix_tokens + 64, mesh=mesh,
                      **{k: v for k, v in local.items() if k != "tokens"})
    return counter.totals()


def collectives_on(cfg, shape: str, mesh) -> tuple[dict, str]:
    """(the cell's per-rank collectives, their source): the partitioned
    program's where it covers the cell (``"program"``), else the specs'
    model (``"specs"``)."""
    if program_covers(cfg, shape, mesh):
        return collective_bytes_from_program(cfg, shape, mesh), "program"
    return collective_bytes_from_specs(cfg, shape, mesh), "specs"


def collectives_for(cfg, shape: str) -> tuple[dict, str]:
    """:func:`collectives_on` the single-pod production mesh, without the
    ``_counts``."""
    with production_mesh_for_counting() as mesh:
        coll, source = collectives_on(cfg, shape, mesh)
    coll.pop("_counts")
    return coll, source


def run_cell(arch: str, shape: str, multi_pod: bool) -> dict:
    from repro_torch.launch.costrun import cell_count

    cfg = get_config(arch)
    spec = SHAPES[shape]
    ok, why = shape_applicable(cfg, spec)
    if not ok:
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}
    t0 = time.time()
    try:
        with production_mesh_for_counting(multi_pod=multi_pod) as mesh:
            n_dev = mesh.size()
            tot = cell_count(arch, shape)
            t_trace = time.time() - t0
            mem = memory_from_specs(cfg, shape, mesh)
            coll, source = collectives_on(cfg, shape, mesh)
        cost = {"flops": tot["flops"] / n_dev, "bytes accessed": tot["bytes"] / n_dev,
                "transcendentals": tot["transcendentals"] / n_dev}
        return {
            "arch": arch, "shape": shape, "multi_pod": multi_pod,
            "status": "ok", "n_devices": n_dev, "trace_s": round(t_trace, 1),
            "memory": mem, "cost": cost, "collectives": coll, "collectives_source": source,
        }
    except Exception as e:
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/torch/dryrun.json")
    args = ap.parse_args(argv)

    cells = []
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    pods = [args.multi_pod] if not args.all else [False, True]
    for mp in pods:
        for a in archs:
            for s in shapes:
                cells.append((a, s, mp))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    for a, s, mp in cells:
        key = f"{a}|{s}|{'multipod' if mp else 'pod'}"
        if results.get(key, {}).get("status") in ("ok", "skipped"):
            print(f"[skip cached] {key}")
            continue
        print(f"[dryrun] {key} ...", flush=True)
        res = run_cell(a, s, mp)
        results[key] = res
        print(f"  -> {res['status']} ({res.get('trace_s', '?')}s trace)"
              if res["status"] == "ok"
              else f"  -> {res['status']}: {res.get('reason', res.get('error'))}",
              flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_skip = sum(1 for r in results.values() if r["status"] == "skipped")
    n_err = sum(1 for r in results.values() if r["status"] == "error")
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors")


if __name__ == "__main__":
    main()

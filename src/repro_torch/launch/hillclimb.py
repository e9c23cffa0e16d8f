"""Perf hillclimbing loop: hypothesis → change → re-count → re-analyse
(port of ``repro.launch.hillclimb``).

Each iteration re-runs the cost count (``launch.costrun``) and the dry run's
per-rank memory (``launch.dryrun``) with a config override, then appends
{cell, change, hypothesis, before, after, verdict} to
``results/torch/perf_iterations.json``. The verdict is the JAX tool's: the
dominant roofline term (the H100's rates, ``launch.roofline``) must fall by
more than 5 % to confirm, and moving less than 5 % either way is neutral.

Each measurement also counts the rank cell: the share of one data group of
the (data=16, model=16) mesh at full width on one card (the global batch
over 16, :func:`rank_batch`, with every weight), its terms the whole share's
over one card's rates; and beside it, for a decode cell that the
partitioned program runs (``dryrun.program_covers``), the partitioned rank
cell (``rank_cell_partitioned``): rank 0 of that mesh on a ``fake`` group, the
same lanes (every KV head, the replicated cache) with 1/16 of the weights,
running its partitioned step (``models.model.decode_step(..., mesh=)``),
its terms the rank's own, collectives included. A ``train_4k`` cell's
partitioned rank holds 1/16 of the weights, its 1/256 ZeRO-1 slice of the
moments and its 16 rows, and runs the in-place partitioned train step at the
dry run's ``TRAIN_ACCUM`` (:func:`rank_cell`, :func:`captured_train_step`).
``--device cuda`` (the default) times that cell's step on the card, every lane full (decode cells; the median
of 10 steps after a warm-up), eagerly and through ``core.interleave``'s
captured decode program (:func:`captured_step`: the card's time, not the
host's), each with ``roofline_share``, its memory term over the step.
``--device meta`` counts only.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --arch llama3-8b --shape decode_32k \\
      --change kv_dtype=float8_e4m3fn \\
      --hypothesis "f8 KV halves cache bytes -> memory term -45%" --device meta
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.core import interleave
from repro_torch.launch import costrun, dryrun
from repro_torch.launch.mesh import production_mesh_for_counting
from repro_torch.launch.partitioned import shard_params
from repro_torch.launch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS

LOG = "results/torch/perf_iterations.json"
DATA_GROUPS = 16    # the production mesh's data axis
CARD_BYTES = 80e9   # one H100's HBM


def _parse_overrides(items):
    out = {}
    for it in items:
        k, v = it.split("=", 1)
        if v in ("true", "True"):
            v = True
        elif v in ("false", "False"):
            v = False
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        out[k] = v
    return out


def terms(cost: dict, *, peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
          link_bw: float = LINK_BW) -> dict:
    coll = sum(v for v in cost.get("collectives", {}).values())
    return {
        "t_compute_s": cost["flops"] / peak_flops,
        "t_memory_s": cost["bytes"] / hbm_bw,
        "t_collective_s": coll / link_bw,
        "flops": cost["flops"], "bytes": cost["bytes"], "collective_bytes": coll,
    }


def memory_capacity(arch: str, shape: str, overrides: dict | None) -> dict:
    """Per-rank memory of the cell on the single-pod mesh (``launch.dryrun``'s
    specs) against one card's: does it fit?"""
    overrides = dict(overrides or {})
    overrides.pop("train_accum", None)
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    with production_mesh_for_counting() as mesh:
        m = dryrun.memory_from_specs(cfg, shape, mesh)
    live = m["argument_bytes"] + m["output_bytes"] - m["alias_bytes"]
    return {"argument_gb": m["argument_bytes"] / 1e9, "temp_gb": None,
            "output_gb": m["output_bytes"] / 1e9, "alias_gb": m["alias_bytes"] / 1e9,
            "live_gb": live / 1e9, "card_gb": CARD_BYTES / 1e9, "fits": live <= CARD_BYTES}


def rank_batch(shape: str) -> int:
    """Lanes of the rank cell: one data group's share of the shape's global
    batch."""
    return max(SHAPES[shape].global_batch // DATA_GROUPS, 1)


def rank_cell(cfg, shape: str, device="cuda", mesh=None, lanes: int | None = None):
    """(params, step, cache) of the rank cell of a decode shape on ``device``:
    weights from seed 0, :func:`rank_batch` lanes (``lanes``: fewer, where
    the rank's cache does not fit one card) of ``seq_len`` slots of K/V
    drawn from N(0, 0.3²) by the same generator, every lane full
    (``costrun.decode_cell``; the audio decoder's encoder memory drawn the
    same way). With ``mesh`` (the production mesh over a
    ``fake`` group: ``launch.mesh.production_mesh_for_counting``) it is the
    calling rank's partitioned cell: its shards of the same weights (the
    full tree freed once they are cut), the same lanes, each step
    ``decode_step(..., mesh=)``, whose collectives move nothing.

    A train shape takes ``mesh`` and gives (params, step, opt_state): the
    rank's shards of the same weights, its ZeRO-1 slices of zero moments,
    :func:`rank_batch` rows of seeded tokens and labels (``step.batch``; a
    vlm's prefix and audio's frames drawn from N(0, 1)), each call one
    in-place partitioned train step at the dry run's ``TRAIN_ACCUM``
    (``costrun.build_cell``)."""
    spec = SHAPES[shape]
    dev = torch.device(device)
    rows = lanes or rank_batch(shape)
    if spec.kind == "train":
        if mesh is None:
            raise ValueError("the train rank cell is the partitioned one: pass mesh=")
        step = costrun.build_cell(cfg, shape, dev, batch=rows, mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(0)
        for v in step.batch.values():
            if v.is_floating_point():
                v.normal_(0.0, 1.0, generator=gen)
            else:
                v.copy_(torch.randint(0, cfg.vocab_size, v.shape, generator=gen, device=dev))
        return step.params, step, step.opt_state
    if spec.kind != "decode":
        raise ValueError(f"the rank cell is a decode or train cell, not {spec.kind}")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = costrun.M.init_params(cfg, gen, device=dev)
    if mesh is not None:
        params = shard_params(params, mesh)
    step, cache = costrun.decode_cell(cfg, rows, spec.seq_len, params, dev, mesh)
    for key in ("k", "v", "cross_k", "cross_v"):
        for layer in cache.get(key, ()):   # a layer at a time: an f8 cache has no normal_
            layer.copy_(torch.empty(layer.shape, dtype=torch.bfloat16, device=dev)
                        .normal_(0.0, 0.3, generator=gen))
    return params, step, cache


def captured_step(cfg, params, cache, mesh=None):
    """The rank cell's step through ``core.interleave``'s captured decode
    program, on a ``StepGraphs`` of its own (``step.graphs``): a step program
    advances the fill it is given, so each call first sets the lanes' fill
    back (the eager step leaves it), and every call is the same step. Its
    first call runs eagerly and its second captures (two warm-ups). With
    ``mesh`` the partitioned cell's step (:func:`rank_cell`)."""
    graphs = interleave.StepGraphs(cache["pos"].device)
    fill = cache["pos"].clone()
    tokens = torch.zeros((fill.shape[0], 1), dtype=torch.int32, device=fill.device)

    def step():
        cache["pos"].copy_(fill)
        return graphs.decode_only_step(params, cache, tokens, cfg, mesh=mesh)

    step.graphs = graphs
    return step


def captured_train_step(cfg, params, opt_state, batch, mesh):
    """The train rank cell's in-place step (:func:`rank_cell`) through a
    ``train.train_step.TrainGraphs`` of its own (``step.graphs``): its first
    call eager, its second captured (two warm-ups), then replays."""
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainGraphs

    graphs = TrainGraphs(batch["tokens"].device)

    def step():
        return graphs.step(params, opt_state, batch, cfg, AdamWConfig(), dryrun.TRAIN_ACCUM,
                           mesh=mesh)

    step.graphs = graphs
    return step


def partitioned_count(cfg, shape: str, lanes: int | None = None) -> dict | None:
    """The partitioned rank cell's count on ``meta``: ``costrun.count``'s
    totals of rank 0's step on the production mesh's ``fake`` group (at
    ``lanes`` rows where the card's cell is cut to them, :func:`rank_cell`),
    with its ``collectives`` (``dist.collectives.CollectiveCounter``,
    without the ``_counts``) and their ``_counts`` under
    ``collective_calls``. None where the cell has no partitioned rank: a
    shape other than decode or train, or one the partitioned program does
    not run (``dryrun.program_covers``)."""
    from repro_torch.dist.collectives import CollectiveCounter

    kind = SHAPES[shape].kind
    if kind not in ("decode", "train"):
        return None
    with production_mesh_for_counting() as mesh:
        if not dryrun.program_covers(cfg, shape, mesh):
            return None
        with CollectiveCounter() as coll:
            out = costrun.count(costrun.build_cell(cfg, shape, batch=lanes or rank_batch(shape),
                                                   mesh=mesh))
    out["collectives"] = coll.totals()
    out["collective_calls"] = out["collectives"].pop("_counts")
    return out


def time_steps(step, steps: int = 10, warmup: int = 1) -> dict:
    """``step`` on the card: ``warmup`` calls, then the median ms of
    ``steps`` calls (host clock, synchronised), each call's ms, and the peak
    memory over the timed calls."""
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return {"step_ms": statistics.median(ms), "steps_ms": ms,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "card": torch.cuda.get_device_name(0)}


def measure(arch: str, shape: str, overrides: dict | None, device: str = "meta"):
    cost_overrides = dict(overrides or {})
    cost_overrides.pop("train_accum", None)  # accum is capacity-only
    cost = costrun.run_cell(arch, shape, cost_overrides or None)
    assert cost["status"] == "ok", cost
    t = terms(cost)
    t["memory_capacity"] = memory_capacity(arch, shape, overrides)
    cfg = get_config(arch)
    if cost_overrides:
        cfg = cfg.replace(**cost_overrides)
    b = rank_batch(shape)
    t["rank_cell"] = {"batch": b, **terms(costrun.count(costrun.build_cell(cfg, shape,
                                                                           batch=b)))}
    part = partitioned_count(cfg, shape)
    if part is not None:
        t["rank_cell_partitioned"] = {"batch": b, **terms(part)}
    if device == "cuda":
        params, step, cache = rank_cell(cfg, shape)
        t["card"] = time_steps(step)
        t["card_captured"] = time_steps(captured_step(cfg, params, cache), warmup=2)
        del params, step, cache
        for k in ("card", "card_captured"):
            t[k]["roofline_share"] = t["rank_cell"]["t_memory_s"] * 1e3 / t[k]["step_ms"]
        torch.cuda.empty_cache()
    return t


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--change", nargs="*", default=[])
    ap.add_argument("--hypothesis", default="")
    ap.add_argument("--baseline-only", action="store_true")
    ap.add_argument("--device", choices=("cuda", "meta"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("hillclimb --device cuda needs a card; --device meta counts only")
    overrides = _parse_overrides(args.change)

    log = []
    if os.path.exists(LOG):
        with open(LOG) as f:
            log = json.load(f)

    before = measure(args.arch, args.shape, None, args.device)
    entry = {"cell": f"{args.arch}|{args.shape}", "change": overrides,
             "hypothesis": args.hypothesis, "before": before}
    if not args.baseline_only:
        after = measure(args.arch, args.shape, overrides, args.device)
        entry["after"] = after
        dom = max(("t_compute_s", "t_memory_s", "t_collective_s"),
                  key=lambda k: before[k])
        delta = after[dom] / before[dom] - 1
        entry["dominant_term"] = dom
        entry["delta_dominant"] = delta
        entry["verdict"] = "confirmed" if delta < -0.05 else (
            "neutral" if abs(delta) <= 0.05 else "refuted")
        print(f"{entry['cell']} {overrides}: {dom} {before[dom]*1e3:.1f}ms -> "
              f"{after[dom]*1e3:.1f}ms ({delta*100:+.1f}%) => {entry['verdict']}")
        print(f"  capacity: {before['memory_capacity']['live_gb']:.1f} -> "
              f"{after['memory_capacity']['live_gb']:.1f} GB/dev")
        for key, what in (("rank_cell", "rank cell"),
                          ("rank_cell_partitioned", "partitioned rank cell")):
            if key not in before or key not in after:
                continue
            rb, ra = before[key], after[key]
            print(f"  {what} at B {ra['batch']}: memory term {rb['t_memory_s']*1e3:.2f} -> "
                  f"{ra['t_memory_s']*1e3:.2f} ms")
        if "card" in before:
            for k, what in (("card", "eager"), ("card_captured", "captured")):
                print(f"  card step, {what}: {before[k]['step_ms']:.2f} -> "
                      f"{after[k]['step_ms']:.2f} ms ({before[k]['card']})")
    log.append(entry)
    os.makedirs(os.path.dirname(LOG), exist_ok=True)
    with open(LOG, "w") as f:
        json.dump(log, f, indent=1)


if __name__ == "__main__":
    main()

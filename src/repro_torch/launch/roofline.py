"""Roofline analysis: three terms per (arch × shape) cell from the cost count
(port of ``repro.launch.roofline``).

    compute term    = flops / peak_FLOP/s
    memory term     = bytes / HBM_bw
    collective term = collective_bytes / link_bw

The flops, bytes and collective bytes are per device, from
``launch.costrun`` (the whole program's count over the mesh's device count)
and ``launch.dryrun`` (a rank's collectives: counted from the partitioned
program where it covers the cell, else what the sharding specs imply; the
cell's ``collectives_source``), so each term is a per-device quantity over a
per-device rate.

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) for train; 2·N·D for
inference steps: the "useful" share of the counted compute.

Hardware: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense
rates without sparsity): :data:`PEAK_FLOPS` 989 TFLOP/s in bf16,
:data:`HBM_BW` 3.35 TB/s. :data:`LINK_BW` is the link that bounds a 16-rank
mesh axis: NVLink 4 (450 GB/s a direction) joins only the 8 GPUs of one node,
so any axis of 16 ranks crosses nodes, over one 400 Gb/s NIC a GPU (50e9 B/s).
The other peaks (:data:`PEAK_INT8_OPS`, :data:`PEAK_TF32_FLOPS`,
:data:`PEAK_F32_FLOPS`) bound single kernels (``chip_smoke.py``). A card set
below 700 W (``nvidia-smi --query-gpu=name,power.limit``) runs below these.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import SHAPES, get_config, shape_applicable

PEAK_FLOPS = 989e12        # bf16 dense, per card
HBM_BW = 3.35e12           # bytes/s per card
LINK_BW = 50e9             # bytes/s: one 400 Gb/s NIC a GPU, between nodes
PEAK_INT8_OPS = 1979e12    # int8 tensor cores
PEAK_TF32_FLOPS = 495e12   # TF32 tensor cores
PEAK_F32_FLOPS = 67e12     # f32 outside the tensor cores
N_CHIPS = 256              # single-pod roofline, as the JAX package's


def bound(nbytes: int, ops: int, peak_ops: float) -> tuple[float, str]:
    """Least time for the work (ms) and what sets it: the bytes that must move
    over :data:`HBM_BW`, or the operations over ``peak_ops``."""
    t_bytes, t_ops = nbytes / HBM_BW, ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def model_flops_per_device(arch: str, shape: str, n_chips: int = N_CHIPS) -> float:
    """Useful model FLOPs per device per step (6ND train / 2ND per token)."""
    cfg = get_config(arch)
    spec = SHAPES[shape]
    n_active = cfg.param_count(active_only=True)
    if spec.kind == "train":
        tokens = spec.seq_len * spec.global_batch
        total = 6.0 * n_active * tokens
    elif spec.kind == "prefill":
        tokens = spec.seq_len * spec.global_batch
        total = 2.0 * n_active * tokens
        # + attention score/value FLOPs (causal): 2 * 2 * L * d * S^2/2 ... folded
        if cfg.family not in ("ssm",):
            hd = cfg.head_dim
            total += 2.0 * cfg.n_layers * cfg.n_heads * hd * spec.seq_len ** 2 \
                * spec.global_batch  # qk + pv, halved by causality, x2 ops
    else:  # decode: one token each, plus KV-cache GEMVs over context
        total = 2.0 * n_active * spec.global_batch
        if cfg.family not in ("ssm",):
            hd = cfg.head_dim
            n_attn = cfg.n_layers if cfg.family != "hybrid" else cfg.n_layers // max(cfg.attn_every, 1)
            total += 4.0 * n_attn * cfg.n_heads * hd * spec.seq_len * spec.global_batch
    return total / n_chips


def analyze(costs: dict, dryrun: dict, *, peak_flops: float = PEAK_FLOPS,
            hbm_bw: float = HBM_BW, link_bw: float = LINK_BW) -> list[dict]:
    """One row per cell of ``costs`` (``launch.costrun``'s results), its
    three terms at the given rates, and its per-device memory from
    ``dryrun`` (``launch.dryrun``'s results)."""
    rows = []
    for arch_shape, c in sorted(costs.items()):
        arch, shape = arch_shape.split("|")
        cfg = get_config(arch)
        spec = SHAPES[shape]
        ok, why = shape_applicable(cfg, spec)
        if not ok or c.get("status") != "ok":
            rows.append({"arch": arch, "shape": shape,
                         "status": c.get("status", "?"),
                         "reason": c.get("reason", c.get("error", ""))})
            continue
        t_comp = c["flops"] / peak_flops
        t_mem = c["bytes"] / hbm_bw
        coll_bytes = sum(v for k, v in c.get("collectives", {}).items())
        t_coll = coll_bytes / link_bw
        dominant = max((("compute", t_comp), ("memory", t_mem),
                        ("collective", t_coll)), key=lambda kv: kv[1])[0]
        mf = model_flops_per_device(arch, shape)
        dr = dryrun.get(f"{arch}|{shape}|pod", {})
        mem = (dr.get("memory") or {})
        rows.append({
            "arch": arch, "shape": shape, "status": "ok",
            "t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
            "dominant": dominant,
            "bound_s": max(t_comp, t_mem, t_coll),
            "model_flops_per_dev": mf,
            "hlo_flops_per_dev": c["flops"],
            "useful_flops_ratio": mf / max(c["flops"], 1.0),
            "roofline_fraction": t_comp / max(t_comp, t_mem, t_coll),
            "hbm_gb_per_dev": ((mem.get("argument_bytes") or 0)
                               + (mem.get("temp_bytes") or 0)
                               + (mem.get("output_bytes") or 0)) / 1e9 or None,
        })
    return rows


def fmt_table(rows: list[dict]) -> str:
    hdr = (f"{'arch':25s} {'shape':12s} {'compute':>10s} {'memory':>10s} "
           f"{'collective':>11s} {'dominant':>10s} {'useful%':>8s} {'roofl%':>7s} {'HBM GB':>7s}")
    out = [hdr, "-" * len(hdr)]
    for r in rows:
        if r["status"] != "ok":
            out.append(f"{r['arch']:25s} {r['shape']:12s} [{r['status']}] {r.get('reason','')[:60]}")
            continue
        out.append(
            f"{r['arch']:25s} {r['shape']:12s} {r['t_compute_s']*1e3:9.2f}ms "
            f"{r['t_memory_s']*1e3:9.2f}ms {r['t_collective_s']*1e3:10.2f}ms "
            f"{r['dominant']:>10s} {100*r['useful_flops_ratio']:7.1f}% "
            f"{100*r['roofline_fraction']:6.1f}% "
            f"{(r['hbm_gb_per_dev'] or 0):7.1f}")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--costs", default="results/torch/costs.json")
    ap.add_argument("--dryrun", default="results/torch/dryrun.json")
    ap.add_argument("--out", default="results/torch/roofline.json")
    args = ap.parse_args(argv)
    with open(args.costs) as f:
        costs = json.load(f)
    dr = {}
    if os.path.exists(args.dryrun):
        with open(args.dryrun) as f:
            dr = json.load(f)
    rows = analyze(costs, dr)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(fmt_table(rows))


if __name__ == "__main__":
    main()

"""The port's launch tooling against the JAX package's, on the CPU.

``launch.roofline`` (``model_flops_per_device`` for all 40 cells float for
float; ``analyze`` and ``fmt_table`` fed the TPU v5e rates of the JAX module,
equal to its rows and table), ``launch.hillclimb`` (``_parse_overrides``,
``terms``) and ``launch.costrun`` (``_reduced_cfgs``' depth vectors); the
cost counter (a dense train cell's GEMM flops against a hand sum; every
family's smoke cells counting the same on ``meta`` and on the CPU; a kernel op
counting its own work and none of its plain version's calls); the kernels'
work formulas pinned to the bounds ``chip_smoke.py`` printed before they moved
into the package; two full-size cells through ``launch.dryrun.run_cell`` on
``meta``, the depth fit equal to a full-depth count, the collectives
equal to a hand sum of the Megatron all-reduces; ``make_production_mesh``
over a fake 256-rank group in a subprocess.

The JAX dry-run tools set ``XLA_FLAGS`` to 512 host devices when imported;
the flags are restored at once, before any JAX backend starts, so the
worker's later JAX tests still see one device. Their ``run_cell`` (a
production compile) is never called here.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.launch import roofline as jroof  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs, shape_applicable  # noqa: E402,E501
from repro_torch.kernels import work  # noqa: E402
from repro_torch.launch import costrun, dryrun, hillclimb, roofline  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TPU = dict(peak_flops=jroof.PEAK_FLOPS, hbm_bw=jroof.HBM_BW, link_bw=jroof.LINK_BW)


def _import_jax_tools():
    """repro.launch.{costrun,hillclimb} with XLA_FLAGS restored after import."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import costrun as jcost
        from repro.launch import hillclimb as jhill
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jcost, jhill


# --------------------------------------------------------------------------
# roofline and hillclimb arithmetic
# --------------------------------------------------------------------------


def test_model_flops_per_device_vs_jax_all_cells():
    cells = [(a, s) for a in list_archs() for s in SHAPES]
    assert len(cells) == 40
    for arch, shape in cells:
        assert roofline.model_flops_per_device(arch, shape) == \
            jroof.model_flops_per_device(arch, shape), (arch, shape)


def _synthetic_costs() -> tuple[dict, dict]:
    r = np.random.default_rng(3)
    costs, drs = {}, {}
    for i, (arch, shape) in enumerate((a, s) for a in list_archs() for s in SHAPES):
        ok, why = shape_applicable(get_config(arch), SHAPES[shape])
        if not ok:
            costs[f"{arch}|{shape}"] = {"status": "skipped", "reason": why}
            continue
        if arch == "rwkv6-1.6b" and shape == "train_4k":
            costs[f"{arch}|{shape}"] = {"status": "error", "error": "synthetic"}
            continue
        costs[f"{arch}|{shape}"] = {"status": "ok", "flops": float(r.uniform(1e9, 1e15)),
                                    "bytes": float(r.uniform(1e8, 1e12)),
                                    "collectives": {"all-gather": float(r.uniform(0, 1e10)),
                                                    "all-reduce": float(i)}}
        drs[f"{arch}|{shape}|pod"] = {"memory": {"argument_bytes": int(r.integers(1, 1e10)),
                                                 "temp_bytes": None,
                                                 "output_bytes": int(r.integers(0, 1e9))}}
    return costs, drs


def test_analyze_and_fmt_table_vs_jax_at_tpu_rates():
    costs, drs = _synthetic_costs()
    rows = roofline.analyze(costs, drs, **TPU)
    assert rows == jroof.analyze(costs, drs)
    assert roofline.fmt_table(rows) == jroof.fmt_table(rows)
    assert {r["status"] for r in rows} == {"ok", "skipped", "error"}
    h100 = roofline.analyze(costs, drs)      # the port's own rates by default
    ok = [(a, b) for a, b in zip(rows, h100) if a["status"] == "ok"]
    assert all(b["t_memory_s"] == pytest.approx(a["t_memory_s"] * jroof.HBM_BW
                                                 / roofline.HBM_BW, rel=1e-12)
               for a, b in ok)


def test_parse_overrides_and_terms_vs_jax():
    _, jhill = _import_jax_tools()
    items = ["kv_dtype=float8_e4m3fn", "remat=false", "quantized_decode=True",
             "n_layers=4", "moe_capacity_factor=1.5", "name=x=y"]
    assert hillclimb._parse_overrides(items) == jhill._parse_overrides(items)
    cost = {"flops": 3.1e14, "bytes": 2.2e11, "collectives": {"all-gather": 7e9}}
    assert hillclimb.terms(cost, **TPU) == jhill.terms(cost)
    assert hillclimb.terms({"flops": 1.0, "bytes": 2.0})["t_collective_s"] == 0
    assert [hillclimb.rank_batch(s) for s in SHAPES] == [16, 2, 8, 1]


@pytest.mark.parametrize("arch,overrides,partitioned", [
    ("llama3-8b", None, True),
    ("olmoe-1b-7b", None, False),                       # MoE: no partitioned program
    ("llama3-8b", {"quantized_decode": True}, False),   # W8A8 is not partitioned
])
def test_hillclimb_measure_partitioned_rank_only_where_covered(arch, overrides, partitioned):
    """``hillclimb.measure`` on ``meta`` at ``decode_32k``: the partitioned
    rank cell (1/16 of the weights, its collectives counted) stands beside
    the rank cell where the partitioned program runs the cell, and is left
    out, not raised on, where it does not."""
    t = hillclimb.measure(arch, "decode_32k", overrides, "meta")
    assert t["rank_cell"]["batch"] == 8
    assert ("rank_cell_partitioned" in t) == partitioned
    if partitioned:
        part, whole = t["rank_cell_partitioned"], t["rank_cell"]
        assert part["batch"] == 8 and part["collective_bytes"] > 0
        assert whole["t_collective_s"] == 0
        assert part["t_memory_s"] < whole["t_memory_s"] / 8


def test_reduced_cfgs_depths_vs_jax():
    jcost, _ = _import_jax_tools()
    from repro.configs import get_config as jget

    for arch in list_archs():
        for shape, spec in SHAPES.items():
            tv, tfull, _ = costrun._reduced_cfgs(get_config(arch), spec)
            jv, jfull, _ = jcost._reduced_cfgs(jget(arch), spec)
            assert tfull == jfull
            assert [d for _, d in tv] == [d for _, d in jv]
            for (tc, _), (jc, _) in zip(tv, jv):
                assert (tc.n_layers, tc.n_encoder_layers) == (jc.n_layers, jc.n_encoder_layers)


# --------------------------------------------------------------------------
# the cost counter
# --------------------------------------------------------------------------


def _small(shape: str, monkeypatch):
    """The shape's kind at smoke size: B 2, 16 tokens (decode: 32 slots)."""
    spec = SHAPES[shape]
    small = dataclasses.replace(spec, global_batch=2,
                                seq_len=32 if spec.kind == "decode" else 16)
    monkeypatch.setitem(costrun.SHAPES, shape, small)
    return small


def test_train_gemm_flops_equal_a_hand_sum(monkeypatch):
    """llama3-8b smoke, f32, no remat: forward, backward (two products per
    forward product) and AdamW (none) count 3 x the forward's GEMMs; causal
    query chunks read the keys up to their end (``causal_block_skip``)."""
    spec = _small("train_4k", monkeypatch)
    cfg = get_config("llama3-8b", smoke=True).replace(dtype="float32",
                                                       param_dtype="float32", remat=False)
    t, b = spec.seq_len, spec.global_batch
    d, f, hq, hkv, hd, v = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                            cfg.vocab_size)
    tokens = b * t
    cq = cfg.q_chunk
    assert t % cq == 0 and cq < t and cfg.causal_block_skip
    pairs = sum(cq * (lo + cq) for lo in range(0, t, cq))   # (query, key) pairs read
    layer = (2 * tokens * d * (hq + 2 * hkv) * hd        # q, k, v
             + 2 * tokens * hq * hd * d                   # o
             + 2 * 2 * b * hq * pairs * hd                # q.K and p.V
             + 3 * 2 * tokens * d * f)                    # gate, up, down
    forward = cfg.n_layers * layer + 2 * tokens * d * v   # + the head
    got = costrun.count(costrun.build_cell(cfg, "train_4k", device="cpu"))
    assert got["flops"] == 3 * forward and not got["kernels"]


@pytest.mark.parametrize("arch", ["llama3-8b", "olmoe-1b-7b", "rwkv6-1.6b", "zamba2-7b",
                                  "internvl2-2b", "seamless-m4t-large-v2"])
def test_smoke_cells_count_the_same_on_meta_and_cpu(arch, monkeypatch):
    """One arch of each family kind, its train, prefill and decode cells."""
    cfg = get_config(arch, smoke=True).replace(dtype="float32", param_dtype="float32",
                                               quantized_decode=True)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        _small(shape, monkeypatch)
        meta = costrun.count(costrun.build_cell(cfg, shape))
        cpu = costrun.count(costrun.build_cell(cfg, shape, device="cpu"))
        assert meta == cpu, (arch, shape)
        assert meta["flops"] > 0 and meta["bytes"] > 0 and meta["transcendentals"] > 0
        if shape == "decode_32k" and cfg.family != "ssm":
            attn = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers
            assert meta["kernels"]["decode_attention"]["calls"] == attn
            assert meta["kernels"]["pim_gemv"]["calls"] > 0


def test_kernel_op_counts_its_own_work_only():
    """On the CPU the op runs its plain version: none of that is counted,
    only the kernel's work at the lanes' capacity; views count nothing, an
    indexed read the rows it reads, and an indexed write into a cache the
    bytes written."""
    from repro_torch.core import kv_mapping
    from repro_torch.kernels.decode_attention.ops import decode_attention_op

    b, hq, hkv, hd, lmax = 2, 8, 2, 16, 64
    q = torch.randn(b, hq, hd)
    k, v = torch.randn(b, hkv, hd, lmax), torch.randn(b, hkv, lmax, hd)
    end = torch.tensor([5, 64], dtype=torch.int32)
    with costrun.CostCounter() as c:
        decode_attention_op(q, k, v, end, scale=0.25)
        k.view(-1).reshape(b, hkv, hd, lmax)
    want = work.attn_work(b * lmax, b, hkv, hq // hkv, hd, b * hq * hd * 4, kv_bytes=4,
                          q_bytes=4)
    assert c.totals() == {"flops": want[1], "bytes": want[0], "transcendentals": 0,
                          "kernels": {"decode_attention": {"calls": 1, "bytes": want[0],
                                                           "ops": want[1]}}}
    table, rows = torch.randn(1000, 64), torch.tensor([3, 7])
    with costrun.CostCounter() as c:
        table[rows]                                   # reads two rows, not the table
    assert c.bytes == 2 * (2 * 64 * 4) + rows.numel() * 8
    cache = kv_mapping.init_cache(2, b, hkv, hd, lmax, torch.float32, "cpu")
    new = torch.randn(b, hkv, 1, hd)
    with costrun.CostCounter() as c:
        kv_mapping.append_layer(cache["k"][0], cache["v"][0], new, new, torch.tensor([3, 9]))
    written = 2 * b * hkv * hd * 4
    assert written < c.bytes < written + 2 * new.numel() * 4 + 1024   # not the cache's size


def test_kernel_work_formulas_pinned():
    """``chip_smoke.py``'s bounds from the package's formulas equal the
    numbers it printed before the formulas moved (its kernel shapes)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    assert [cs.gemv_bound(n, k, 4)[0] for n, k, _ in cs.GEMV_LAYER] == [
        0.005037473432835821, 0.00126304, 0.017618918208955222, 0.01757001074626866]
    assert cs.gemv_bound(4096, 36864, 8) == (0.045205177313432834, "bytes")
    end = torch.tensor(cs.ATTN_END, dtype=torch.int32)
    start = torch.tensor(cs.ATTN_START, dtype=torch.int32)
    out = 4 * 8 * 4 * 128 * 4
    assert cs.attn_bound(end, start, out) == (0.003727980895522388, "bytes")
    assert cs.attn_bound(end, start, out, kv_bytes=1) == (0.0018786674626865673, "bytes")
    assert cs.attn_bound(end, start, 4 * 32 * 112 * 4, hkv=32, g=1, hd=112) == \
        (0.01297088, "bytes")
    from repro_torch.kernels.decode_attention import ref
    _, n_real = ref.realized_splits(cs.ATTN_NB, 4)
    assert cs.attn_bound(end, start, 4 * 8 * n_real * 4 * 130 * 4)[0] == 0.0037878925373134326
    assert roofline.bound(*work.merge_work(4, 8, n_real, 4, 128), roofline.PEAK_FLOPS)[0] == \
        9.90376119402985e-05
    ssd = cs.ssd_work(4, 2048)
    assert (ssd["bytes"], ssd["recurrence_flops"], ssd["chunked_flops"], ssd["bound_ms"],
            ssd["bound_f32_cores_ms"]) == (492306432, 18790481920, 16987455488,
                                           0.14695714388059702, 0.28045495402985077)


# --------------------------------------------------------------------------
# the dry run at full size, and the production mesh
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_dryrun_full_size_llama_on_meta(shape):
    res = dryrun.run_cell("llama3-8b", shape, False)
    assert res["status"] == "ok", res.get("trace")
    assert res["n_devices"] == 256
    assert set(res) >= {"arch", "shape", "multi_pod", "status", "n_devices", "memory",
                        "cost", "collectives"}
    mem, cost = res["memory"], res["cost"]
    assert set(mem) >= {"output_bytes", "temp_bytes", "argument_bytes"} and \
        mem["temp_bytes"] is None
    assert set(cost) == {"flops", "bytes accessed", "transcendentals"}
    useful = roofline.model_flops_per_device("llama3-8b", shape)
    assert 0.9 * useful < cost["flops"] < 1.5 * useful
    if shape == "decode_32k":
        # one data group's 8 lanes of 32,768 slots: 8 x 32 layers x 8 heads x 128 x 2 x 2 B
        kv = 8 * 32768 * 32 * 8 * 128 * 2 * 2
        assert mem["alias_bytes"] == kv + 4        # the cache and its scalar pos
        assert cost["bytes accessed"] > kv * 16 / 256
        # the depth fit equals a count of all 32 layers
        full = costrun.count(costrun.build_cell(get_config("llama3-8b"), shape))
        for k, key in (("flops", "flops"), ("bytes", "bytes accessed"),
                       ("transcendentals", "transcendentals")):
            assert cost[key] * 256 == pytest.approx(full[k], rel=1e-12, abs=1e-3)
        assert costrun.cell_count("llama3-8b", shape)["kernels"] == full["kernels"]
    coll = dict(res["collectives"])
    counts = coll.pop("_counts")
    # counted from the partitioned program (rank 0 of (data 16, model 16))
    assert res["collectives_source"] == "program"
    d, n_l, kv = 4096, 32, 1024              # kv: the 8 KV heads' 128 columns
    if shape == "decode_32k":
        # Megatron all-reduces (2x each) of a rank's 8 lanes' bf16 activations,
        # wo and w_down in 32 layers and the embedding, and one all-gather a
        # layer of the new token's K/V (8 lanes x 2 x 1,024 columns, bf16)
        b, t = 8, 1
        want = 2.0 * b * t * d * 2 * (2 * n_l + 1)
        assert coll == pytest.approx({"all-reduce": want, "all-gather": 32 * 8 * 2 * 1024 * 2},
                                     rel=1e-12)
        assert counts == {"all-reduce": 2 * 32 + 1, "all-gather": 32}
        return
    # train: the rank's 16 rows in 4 microbatches of 4 x 4,096 tokens, remat on.
    # A microbatch all-reduces its bf16 activations (b·T·d, 2x each) 2 + 5 x 32
    # times: the embedding and the head's input gradient; a layer's two block
    # reductions forward, their two conjugates (the column inputs' gradients)
    # backward, and the attention's reduction again in the recompute (which
    # stops at w_down's saved input, before the MLP's reduction); and the loss
    # reduces three f32 statistics a token (the max, the sum of exps, the gold
    # logit) over the vocab shards in two calls a 1,024-token chunk. A step
    # adds two f32 scalars (the loss over the data axis, the clip's norm over
    # the mesh). K/V: an all-gather a layer forward and in the recompute, a
    # reduce-scatter a layer backward (64 of 1,024 columns a rank). ZeRO-1:
    # each of the 12 leaves' f32 gradient reduce-scattered over data to its
    # owner (a 1/16 slice of the rank's shard) and its bf16 update
    # all-gathered back (the rank's shard whole).
    accum, b, t, a = 4, 4, 4096, 2
    cfg = get_config("llama3-8b")
    sharded = sum(math.prod(x) for x in (
        (cfg.vocab_size, d), (d, cfg.vocab_size),
        *[(n_l, d, n) for n in (4096, kv, kv, 4096, 14336, 14336, 14336)]))
    shard = sharded // 16 + n_l * 2 * d + d             # a rank's params, elements
    act = b * t * d * a
    want = {"all-reduce": 2.0 * (accum * (2 + 5 * n_l) * act + accum * b * t * 3 * 4 + 2 * 4),
            "all-gather": accum * 2 * n_l * 2 * b * t * kv * a + shard * a,
            "reduce-scatter": accum * n_l * 2 * b * t * (kv // 16) * a + shard // 16 * 4}
    assert coll == pytest.approx(want, rel=1e-12)
    assert counts == {"all-reduce": accum * (2 + 5 * n_l) + accum * 2 * (t // 1024) + 2,
                      "all-gather": accum * 2 * n_l + 12,
                      "reduce-scatter": accum * n_l + 12}


def test_make_production_mesh_on_a_fake_group():
    code = (
        "import torch.distributed as dist\n"
        "from repro_torch.launch import mesh as M\n"
        "try:\n"
        "    M.make_production_mesh(device='cpu')\n"
        "    raise SystemExit('built without a group')\n"
        "except ValueError:\n"
        "    pass\n"
        "for mp, shape in ((False, (16, 16)), (True, (2, 16, 16))):\n"
        "    with M.production_mesh_for_counting(multi_pod=mp) as m:\n"
        "        assert tuple(m.mesh.shape) == shape and m.size() == (512 if mp else 256)\n"
        "        assert M.batch_axes(m) == (('pod', 'data') if mp else ('data',))\n"
        "        assert M.make_production_mesh(multi_pod=mp, device='cpu').size() == m.size()\n"
        "    assert not dist.is_initialized()\n"
        "dist.init_process_group('gloo', store=dist.HashStore(), rank=0, world_size=1)\n"
        "try:\n"
        "    with M.production_mesh_for_counting():\n"
        "        raise SystemExit('replaced a live group')\n"
        "except ValueError:\n"
        "    assert dist.get_world_size() == 1\n"
        "dist.destroy_process_group()\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, check=True, timeout=120)

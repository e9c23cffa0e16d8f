"""The partitioned train step against the JAX package's unsharded one, on the
CPU over real ``gloo`` groups.

* ``train.train_step.train_step`` with ``mesh=`` (tensor parallelism over
  ``model``, data parallelism and ZeRO-1 over the batch axes, autograd
  through the collectives) for the three dense llama-style smoke configs in
  f32 (``yi-9b-smoke``'s one KV head splits at model 2 and 4 and its three
  layers fold ZeRO-1 elsewhere than the layer dim at data 2; codeqwen's
  q/k/v biases are drawn non-zero and split over ``model``), once with
  ``remat=True`` and once with ``seq_parallel=True``, on meshes (data,
  model) = (1, 2), (2, 1), (2, 2), (1, 4), (4, 1) (two layers do not split
  over four data ranks: ZeRO-1 folds into another dim) and the multi-pod
  axes (pod, data, model) = (2, 2, 1) (the batch axes one group of two
  mesh dims): a global batch of 8 x 16 tokens, ``accum`` 2, two steps. Each
  step's loss and ``grad_norm`` match ``repro.train.train_step.train_step``
  on the same numpy params and batch to ``rtol=1e-5``, on every rank; the
  params and moments gathered back (``dist.sharding.full_tree``) match to
  ``rtol=1e-5`` with an atol of 1e-5 x the leaf's max |x|. The two-rank
  group runs the functional step, the four-rank group the in-place one.
* Counts: each rank's ``CollectiveCounter`` totals equal the ``meta`` count
  of the same steps over a ``fake`` group of the mesh's size, kind by kind;
  no kernel launches; each rank holds the bytes its specs give it.
* On ``meta`` at the production mesh: llama3-8b's rank holds the moments of
  two of 32 layers (``dryrun.per_rank_bytes`` of ``opt_state_shardings``).
* On one rank, the functional and the in-place partitioned steps are bit
  for bit each other's.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.dist import sharding as shard_lib  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import partitioned  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train.optimizer import OptState, tree_leaves  # noqa: E402
from repro_torch.train.train_step import train_step, train_step_  # noqa: E402

ARCHS = ["llama3-8b", "yi-9b", "codeqwen1.5-7b"]
CASES = ARCHS + ["llama3-8b+remat", "llama3-8b+sp"]
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4), (4, 1), (2, 2, 1)]}
B, S, ACCUM, STEPS = 8, 16, 2, 2
RTOL, ATOL_OF_MAX = 1e-5, 1e-5


def _configs(case):
    arch, _, variant = case.partition("+")
    jcfg = get_config(arch, smoke=True).replace(dtype="float32", param_dtype="float32")
    tcfg = ModelConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    return jcfg, tcfg.replace(remat=variant == "remat", seq_parallel=variant == "sp")


def _jax_params(jcfg):
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    if jcfg.qkv_bias:   # JAX inits them to zeros: draw them, so the test sees them
        r = np.random.default_rng(9)
        attn = dict(jp["layers"]["attn"])
        for k in ("bq", "bk", "bv"):
            attn[k] = jnp.asarray((r.standard_normal(attn[k].shape) * 0.5).astype(np.float32))
        jp = {**jp, "layers": {**jp["layers"], "attn": attn}}
    return jp


def _batch(jcfg):
    r = np.random.default_rng(4)
    return {k: r.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _by_path(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_by_path(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's unsharded jitted ``train_step`` per arch, STEPS
    steps at ACCUM: (numpy params, batch, metrics a step, params, m, v by
    path). ``remat`` and ``seq_parallel`` leave its numbers as they are."""
    out = {}
    opt = jopt.AdamWConfig(**dataclasses.asdict(partitioned.TRAIN_OPT))
    for arch in ARCHS:
        jcfg, _ = _configs(arch)
        jp = _jax_params(jcfg)
        batch = _batch(jcfg)
        params, state, metrics = jp, jopt.init_opt_state(jp), []
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        for _ in range(STEPS):
            params, state, m = jstep.train_step(params, state, jb, jcfg, opt, ACCUM)
            metrics.append({k: float(v) for k, v in m.items()})
        out[arch] = (jax.tree_util.tree_map(np.asarray, jp), batch, metrics,
                     _by_path(params), _by_path(state.m), _by_path(state.v))
    return out


@pytest.fixture(scope="module")
def groups(jax_runs):
    """Every case on every mesh: a two-rank group (the functional step) and a
    four-rank one (in place), each rank's results by world size."""
    jobs = []
    for case in CASES:
        params, batch = jax_runs[case.split("+")[0]][:2]
        jobs.append((_configs(case)[1], params, batch))
    return {world: tmesh.spawn(partitioned.train_run, world, jobs, meshes, STEPS, ACCUM, "cpu",
                               functional=world == 2)
            for world, meshes in MESHES.items()}


def _case_mesh():
    return [(case, shape) for case in CASES for world in MESHES for shape in MESHES[world]]


def _ranks(groups, case, shape):
    world = int(np.prod(shape))
    mi = MESHES[world].index(shape)
    return [r[CASES.index(case)][mi] for r in groups[world]]


@pytest.mark.parametrize("case,shape", _case_mesh())
def test_partitioned_train_step_matches_jax(groups, jax_runs, case, shape):
    jmetrics, jparams, jm, jv = jax_runs[case.split("+")[0]][2:]
    ranks = _ranks(groups, case, shape)
    for r in ranks:
        assert len(r["metrics"]) == STEPS
        for got, want in zip(r["metrics"], jmetrics):
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=(k, r["coords"]))
        assert r["metrics"] == ranks[0]["metrics"], r["coords"]   # the same on every rank
    for name, want in (("params", jparams), ("m", jm), ("v", jv)):
        got = ranks[0][name]
        assert set(got) == set(want)
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, rtol=RTOL,
                                       atol=ATOL_OF_MAX * float(np.abs(w).max()),
                                       err_msg=f"{name} {path}")


@pytest.mark.parametrize("shape", [s for w in MESHES for s in MESHES[w]])
def test_train_counts_meta_equal_gloo(groups, shape):
    """Kind by kind, every gloo rank's count equals the meta count over a
    fake group; no launches; the rank's params and moments are its specs'
    bytes (``dryrun.per_rank_bytes``)."""
    for case in CASES:
        cfg = _configs(case)[1]
        meta = partitioned.count_train_run(cfg, shape, B, S, STEPS, ACCUM)
        with tmesh.counting_mesh(shape, partitioned.mesh_axes(shape)) as m:
            specs = TM.param_specs(cfg)
            p_pairs = dryrun._leaves_with_specs(specs, shard_lib.param_shardings(specs, m))
            o_sh = shard_lib.opt_state_shardings(OptState(None, specs, specs), m)
            moments = 2 * dryrun.per_rank_bytes(
                [(torch.empty(t.shape, dtype=torch.float32, device="meta"), sp)
                 for t, sp in dryrun._leaves_with_specs(specs, o_sh.m)], m)
            params = dryrun.per_rank_bytes(p_pairs, m)
        for r in _ranks(groups, case, shape):
            assert r["collectives"] == meta, (case, r["coords"])
            assert not any(r["launches"].values())   # the CPU runs the plain versions
            assert (r["param_bytes"], r["moment_bytes"]) == (params, moments), case
        if shape[-1] > 1:
            assert meta["_counts"]["reduce-scatter"] > 0     # the K/V gathers' backward
        if np.prod(shape[:-1]) > 1:
            assert meta["_counts"]["all-gather"] > 0         # the params back to the data ranks


def test_rank_holds_its_zero1_slice_on_the_production_mesh():
    """llama3-8b at (data 16, model 16): every layer moment folds data into
    the layer dim, so rank 0 holds layers 0 and 1 only, 1/256 of the
    moments (``per_rank_bytes`` of ``opt_state_shardings``)."""
    cfg = t_get_config("llama3-8b")
    with tmesh.production_mesh_for_counting() as m:
        state = shard_lib.local_opt_state(cfg, m, "meta")
        specs = TM.param_specs(cfg)
        o_sh = shard_lib.opt_state_shardings(OptState(None, specs, specs), m)
        want = dryrun.per_rank_bytes(
            [(torch.empty(t.shape, dtype=torch.float32, device="meta"), sp)
             for t, sp in dryrun._leaves_with_specs(specs, o_sh.m)], m)
        plan = shard_lib.zero1_plan(cfg, m)
    assert sum(t.numel() * 4 for t in tree_leaves(state.m)) == want
    for path, z in plan.items():
        if path.startswith("layers/"):
            assert z.fold == 0 and z.moment_shape[0] == 2, path
    assert state.m["layers"]["attn"]["wq"].shape == (2, 4096, 256)
    assert plan["embed/w"].fold == 1 and plan["lm_head/w"].fold == 0


def test_functional_and_in_place_partitioned_steps_are_bit_equal():
    """One rank (a world-size-1 gloo group, mesh (1, 1)): both forms from the
    same params and batch, two steps at accum 2."""
    import torch.distributed as dist

    cfg = _configs("codeqwen1.5-7b")[1]
    gen = torch.Generator().manual_seed(3)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
             for k in ("tokens", "labels")}
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = tmesh.make_mesh((1, 1), partitioned.AXES, device="cpu")
        outs = []
        for in_place in (False, True):
            params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
            state = shard_lib.local_opt_state(cfg, mesh, "cpu")
            for _ in range(STEPS):
                if in_place:
                    metrics = train_step_(params, state, batch, cfg, partitioned.TRAIN_OPT,
                                          ACCUM, mesh=mesh)
                else:
                    params, state, metrics = train_step(params, state, batch, cfg,
                                                        partitioned.TRAIN_OPT, ACCUM, mesh=mesh)
            outs.append((metrics, tree_leaves(params), tree_leaves(state.m),
                         tree_leaves(state.v), state.step))
    finally:
        dist.destroy_process_group()
    (m0, *trees0), (m1, *trees1) = outs
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for a, b in zip(trees0, trees1):
        for x, y in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_dryrun_covers_the_dense_train_cells(multi_pod):
    """``train_4k`` reads the program for the three dense archs, gemma2-27b,
    internvl2-2b and seamless-m4t-large-v2 on both production meshes (their
    count: ``test_torch_launch_tools.py``'s full-size llama3-8b cell,
    ``test_torch_partitioned.py``'s dry-run cells and ``chip_smoke.py
    --cost``'s sweep); gemma2's rings, MoE, the hybrid and rwkv6 stay on the
    specs' model."""
    with tmesh.production_mesh_for_counting(multi_pod=multi_pod) as m:
        for arch in ARCHS + ["gemma2-27b", "internvl2-2b", "seamless-m4t-large-v2"]:
            assert dryrun.program_covers(t_get_config(arch), "train_4k", m), arch
        assert not dryrun.program_covers(
            t_get_config("gemma2-27b").replace(windowed_kv_cache=True), "train_4k", m)
        for arch in ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "zamba2-7b", "rwkv6-1.6b"):
            assert not dryrun.program_covers(t_get_config(arch), "train_4k", m), arch


def test_train_cell_counts_the_same_at_its_first_step():
    """``launch.costrun.CostCounter`` sees the partitioned step alone: the
    step's ZeRO-1 plan, read off a ``meta`` params tree at its first call,
    is not counted, so a card's first count equals a ``meta`` count made
    after it (``chip_smoke.py --cost``)."""
    from repro_torch.launch import costrun
    from repro_torch.train import train_step as ts

    cfg = t_get_config("llama3-8b", smoke=True).replace(remat=True)
    with tmesh.counting_mesh((2, 2), partitioned.AXES) as m:
        ts._plan.cache_clear()
        params = partitioned.shard_params(TM.init_params(cfg, None, device="meta"), m)
        state = shard_lib.local_opt_state(cfg, m, "meta")
        rows = {k: torch.zeros((B // 2, S), dtype=torch.long, device="meta")
                for k in ("tokens", "labels")}

        def step():
            return train_step_(params, state, rows, cfg, partitioned.TRAIN_OPT, ACCUM, mesh=m)

        first, second = costrun.count(step), costrun.count(step)
    assert first == second

"""The port's shape cells, param specs and ``dist/`` on one rank against the
JAX package's, on the CPU.

* ``configs``: ``SHAPES``, ``shape_applicable``, ``all_cells``,
  ``param_count`` and ``input_specs`` (``meta`` tensors for
  ``ShapeDtypeStruct``s) equal the JAX package's for every arch and shape.
* ``models.model.param_specs``: the stacked ``meta`` tree has the JAX
  package's paths, shapes and dtypes leaf for leaf for every arch's full
  config, and the real init's (stacked) at smoke size.
* ``dist.sharding``: every spec equals ``tuple(PartitionSpec)`` of the JAX
  rule for every param, optimizer-moment, batch and cache leaf of every arch
  (``tests/test_sharding.py``'s contracts: the literal rules, the divisibility
  rule, ZeRO-1 and the long-context fold), on a ``(1, 1)`` ``("data",
  "model")`` mesh over a world-size-1 gloo group started on a ``HashStore``
  (no network port), with DTensor placements.
* ``dist.collectives``: ``quantize_grad``/``dequantize_grad`` bit for bit
  against JAX's on the same inputs, and ``tests/test_collectives.py``'s two
  contracts.
* ``seq_parallel`` is the identity on one rank (``tests/test_beyond_paper.py:51``),
  and the elastic re-shard on restore (``tests/test_train.py:62``): a
  checkpoint written unsharded restores as DTensors whose full tensors, and
  the loss on them, equal the plain restore's bit for bit.
"""
import dataclasses
import functools
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as tdist  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.dist import collectives as jcoll  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train.optimizer import init_opt_state as j_init_opt  # noqa: E402
from repro_torch.dist import collectives as tcoll  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train.optimizer import init_opt_state, tree_leaves, tree_map  # noqa: E402

ARCHS = jconfigs.list_archs()


def _jdtype(t: torch.dtype) -> str:
    return str(t).replace("torch.", "")


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts, paths joined by ``/``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@functools.lru_cache(maxsize=None)
def _tparams(arch):
    """The port's param_specs of an arch's full config (built once)."""
    return TM.param_specs(tconfigs.get_config(arch))


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return JM.param_specs(jconfigs.get_config(arch))


def _jflat(tree):
    return {jsh._path_str(p): leaf for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def meshes():
    """(port mesh over a world-size-1 gloo group, JAX mesh), both (1, 1)
    ``("data", "model")``; the group is destroyed at the end."""
    from repro_torch.launch.mesh import make_mesh

    started = not tdist.is_initialized()
    if started:
        tdist.init_process_group("gloo", store=tdist.HashStore(), rank=0, world_size=1)
    yield (make_mesh((1, 1), ("data", "model"), device="cpu"),
           jax.make_mesh((1, 1), ("data", "model")))
    if started:
        tdist.destroy_process_group()


def test_mesh_module_is_pure():
    """Importing launch.mesh starts no process group and touches no device."""
    import repro_torch.launch.mesh as mesh_mod
    before = tdist.is_initialized()
    importlib.reload(mesh_mod)
    assert tdist.is_initialized() == before
    assert not torch.cuda.is_initialized()
    assert callable(mesh_mod.make_production_mesh)   # builds only when called


# ---- shape cells -------------------------------------------------------------


def test_shape_cells_equal_jax():
    assert ({k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()})
    assert tconfigs.all_cells() == jconfigs.all_cells()
    assert len(tconfigs.all_cells()) == 40
    assert sum(ok for _, _, ok, _ in tconfigs.all_cells()) == 32   # 8 long_500k skips


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_param_count_equal_jax(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.param_count(active_only=True) == jcfg.param_count(active_only=True)
    assert (tcfg.is_attention_free, tcfg.supports_long_context) == \
        (jcfg.is_attention_free, jcfg.supports_long_context)
    for sname in jconfigs.SHAPES:
        tspec, jspec = tconfigs.SHAPES[sname], jconfigs.SHAPES[sname]
        assert tconfigs.shape_applicable(tcfg, tspec) == jconfigs.shape_applicable(jcfg, jspec)
        t, j = tconfigs.input_specs(tcfg, tspec), jconfigs.input_specs(jcfg, jspec)
        assert list(t) == list(j)
        for k in j:
            assert t[k].device.type == "meta"
            assert (tuple(t[k].shape), _jdtype(t[k].dtype)) == (j[k].shape, str(j[k].dtype))


# ---- param specs ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch):
    t, j = _flat(_tparams(arch)), _jflat(_jparams(arch))
    assert sorted(t) == sorted(j)
    for k, leaf in t.items():
        assert leaf.device.type == "meta"
        assert (tuple(leaf.shape), _jdtype(leaf.dtype)) == (j[k].shape, str(j[k].dtype)), k


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_real_init(arch):
    """At smoke size: the stacked real init has param_specs' leaves."""
    cfg = tconfigs.get_config(arch, smoke=True)
    real = _flat(TM.stack_layers(TM.init_params(cfg, torch.Generator().manual_seed(0),
                                                device="cpu"), torch.stack))
    spec = _flat(TM.param_specs(cfg))
    assert list(real) == list(spec)
    for k in real:
        assert (real[k].shape, real[k].dtype) == (spec[k].shape, spec[k].dtype), k


# ---- sharding rules ---------------------------------------------------------------


def test_param_pspec_rules():
    """tests/test_sharding.py::test_param_pspec_rules on meta leaves."""
    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")
    leaf2, leaf3 = meta(4096, 14336), meta(32, 4096, 14336)
    assert tsh.param_pspec("layers/mlp/w_gate", leaf3) == tuple(P(None, None, "model"))
    assert tsh.param_pspec("layers/mlp/w_down", leaf3) == tuple(P(None, "model", None))
    assert tsh.param_pspec("embed/w", leaf2) == tuple(P("model", None))
    assert tsh.param_pspec("lm_head/w", leaf2) == tuple(P(None, "model"))
    moe = meta(16, 64, 2048, 1024)
    assert tsh.param_pspec("layers/moe/w_gate", moe) == tuple(P(None, "model", None, None))
    assert tsh.param_pspec("final_norm/scale", meta(4096)) == tuple(P())


@pytest.mark.parametrize("arch", ARCHS)
def test_model_axis_shards_divide(arch):
    """Every dim assigned to `model` divides by 16 (odd vocabs excepted)."""
    bad = []
    for path, leaf in _flat(_tparams(arch)).items():
        for dim, ax in enumerate(tsh.param_pspec(path, leaf)):
            if ax == "model" and leaf.shape[dim] % 16 != 0:
                bad.append((path, tuple(leaf.shape), dim))
    bad = [b for b in bad if "embed" not in b[0] and "lm_head" not in b[0]]
    assert not bad, f"{arch}: non-divisible model shards {bad}"


@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_equal_jax_for_every_leaf(meshes, arch):
    """Params, ZeRO-1 moments, every shape cell's inputs and decode caches."""
    tmesh, jmesh = meshes
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    tparams, jparams = _tparams(arch), _jparams(arch)

    def same(t_tree, j_tree):
        t, j = _flat(t_tree), _jflat(j_tree)
        assert sorted(t) == sorted(j)
        for k in j:
            assert t[k].spec == tuple(j[k].spec), k
            t[k].placements       # every spec maps to placements on the mesh
    same(tsh.param_shardings(tparams, tmesh), jsh.param_shardings(jparams, jmesh))
    topt = tsh.opt_state_shardings(init_opt_state(tparams), tmesh)
    jopt = jsh.opt_state_shardings(jax.eval_shape(j_init_opt, jparams), jmesh)
    assert topt.step.spec == tuple(jopt.step.spec)
    same(topt.m, jopt.m)
    same(topt.v, jopt.v)
    for sname in jconfigs.SHAPES:
        tspec, jspec = tconfigs.SHAPES[sname], jconfigs.SHAPES[sname]
        same(tsh.batch_shardings(tcfg, tspec, tmesh, tconfigs.input_specs(tcfg, tspec)),
             jsh.batch_shardings(jcfg, jspec, jmesh, jconfigs.input_specs(jcfg, jspec)))
        if jspec.is_decode:
            same(tsh.cache_shardings(tcfg, tspec, tmesh, TM.decode_cache_specs(
                     tcfg, tspec.global_batch, tspec.seq_len)),
                 jsh.cache_shardings(jcfg, jspec, jmesh, JM.decode_cache_specs(
                     jcfg, jspec.global_batch, jspec.seq_len)))


def test_per_layer_tree_takes_the_stacked_specs(meshes):
    """A per-layer params tree is stacked before the rules read it."""
    tmesh, _ = meshes
    cfg = tconfigs.get_config("llama3-8b", smoke=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert ({k: s.spec for k, s in _flat(tsh.param_shardings(params, tmesh)).items()}
            == {k: s.spec for k, s in
                _flat(tsh.param_shardings(TM.param_specs(cfg), tmesh)).items()})


def test_zero1_opt_sharding_adds_data_axis(meshes):
    tmesh, _ = meshes
    cfg = tconfigs.get_config("llama3-8b", smoke=True)
    shard = tsh.opt_state_shardings(init_opt_state(TM.param_specs(cfg)), tmesh)
    spec = shard.m["layers"]["mlp"]["w_gate"].spec
    axes = {a for s in spec if s for a in (s if isinstance(s, tuple) else (s,))}
    assert "model" in axes and "data" in axes


def test_cache_sharding_long_context_folds_all_axes(meshes):
    tmesh, _ = meshes
    cfg = tconfigs.get_config("zamba2-7b")
    spec = tconfigs.SHAPES["long_500k"]
    cache = TM.decode_cache_specs(cfg, spec.global_batch, spec.seq_len)
    k = tsh.cache_shardings(cfg, spec, tmesh, cache)["k"]
    assert k.spec[-1] == ("data", "model")
    from torch.distributed.tensor import Replicate, Shard
    nd = len(cache["k"][0])
    assert k.placements == (Shard(nd - 1), Shard(nd - 1))
    assert tsh.replicated(tmesh).placements == (Replicate(), Replicate())


def test_placements_follow_the_mesh_order(meshes):
    from torch.distributed.tensor import Replicate, Shard
    tmesh, _ = meshes
    assert tsh.NamedSharding(tmesh, (None, "model")).placements == (Replicate(), Shard(1))
    assert tsh.NamedSharding(tmesh, ("data", None, "model")).placements == (Shard(0), Shard(2))
    with pytest.raises(ValueError, match="mesh's dim order"):
        tsh.NamedSharding(tmesh, (("model", "data"),)).placements


# ---- collectives -------------------------------------------------------------------


def _inputs():
    rng = np.random.default_rng(0)
    g = (rng.standard_normal((256, 128)) * 0.01).astype(np.float32)
    g[3] = 0.0                                        # an all-zero row: the 1e-12 floor
    g[4, :4] = [2.54, 0.01, 0.03, -0.05]              # near-ties of the rounding
    return [g, (rng.standard_normal((3, 5, 64)) * 1e-3).astype(np.float32),
            rng.standard_normal(33).astype(np.float32)]


@pytest.mark.parametrize("case", range(3))
def test_quantize_grad_equals_jax_bitwise(case):
    g = _inputs()[case]
    q, s = tcoll.quantize_grad(torch.from_numpy(g))
    jq, js = jcoll.quantize_grad(jnp.asarray(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    d, jd = tcoll.dequantize_grad(q, s), jcoll.dequantize_grad(jq, js)
    np.testing.assert_array_equal(d.numpy().view(np.uint32), np.asarray(jd).view(np.uint32))
    # every element's error is at most half its row's scale
    assert bool(((d - torch.from_numpy(g)).abs() <= s * (0.5 + 2.0**-14)).all())
    gb = torch.from_numpy(g).to(torch.bfloat16)       # a bf16 gradient widens first
    qb, sb = tcoll.quantize_grad(gb)
    jqb, jsb = jcoll.quantize_grad(jnp.asarray(gb.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(qb.numpy(), np.asarray(jqb))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(jsb))


def test_grad_quantization_roundtrip():
    """tests/test_collectives.py:14 on the port: gaussian gradients."""
    g = torch.from_numpy((np.random.default_rng(1).standard_normal((256, 128)) * 0.01)
                         .astype(np.float32))
    q, s = tcoll.quantize_grad(g)
    rel = float(torch.linalg.norm(tcoll.dequantize_grad(q, s) - g) / torch.linalg.norm(g))
    assert rel < 0.01 and q.dtype == torch.int8
    assert q.element_size() * q.numel() * 4 == g.element_size() * g.numel()


def test_error_feedback_unbiased_over_steps():
    """tests/test_collectives.py:23 on the port, and every step's bits equal
    the JAX loop's."""
    rng = np.random.default_rng(0)
    g_np = (rng.standard_normal((64, 64)) * 1e-3).astype(np.float32)
    g, jg = torch.from_numpy(g_np), jnp.asarray(g_np)
    err, jerr = torch.zeros_like(g), jnp.zeros_like(jg)
    total, jtotal = torch.zeros_like(g), jnp.zeros_like(jg)
    for _ in range(20):
        corrected, jcorrected = g + err, jg + jerr
        deq = tcoll.dequantize_grad(*tcoll.quantize_grad(corrected))
        jdeq = jcoll.dequantize_grad(*jcoll.quantize_grad(jcorrected))
        err, jerr = corrected - deq, jcorrected - jdeq
        total, jtotal = total + deq, jtotal + jdeq
        np.testing.assert_array_equal(total.numpy(), np.asarray(jtotal))
    rel = float(torch.linalg.norm(total / 20 - g) / torch.linalg.norm(g))
    assert rel < 0.01


# ---- seq_parallel and the elastic restore -----------------------------------------


def test_seq_parallel_is_the_identity_on_one_rank():
    """tests/test_beyond_paper.py:51: the same forward bits with and without."""
    cfg = tconfigs.get_config("internvl2-2b", smoke=True).replace(dtype="float32",
                                                                  param_dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=gen),
             "prefix_embeds": 0.02 * torch.randn((2, cfg.n_prefix_tokens, cfg.d_model),
                                                 generator=gen)}
    x1 = TM.forward(params, batch, cfg)
    x2 = TM.forward(params, batch, cfg.replace(seq_parallel=True))
    assert torch.equal(x1, x2)


def test_elastic_reshard_on_restore(meshes, tmp_path):
    """tests/test_train.py:62: a checkpoint written unsharded restores under
    explicit shardings (the params' and ZeRO-1 moments' rules) as DTensors;
    every leaf's full tensor and the loss on the gathered params equal the
    plain restore's bit for bit."""
    from torch.distributed.tensor import DTensor

    tmesh, _ = meshes
    cfg = tconfigs.get_config("llama3-8b", smoke=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = init_opt_state(params)
    opt = opt._replace(m=tree_map(lambda t: t + 0.5, opt.m),
                       v=tree_map(lambda t: t + 0.25, opt.v))
    checkpoint.save(str(tmp_path), 1, params, opt, extra={"next_step": 1})
    p1, o1, _ = checkpoint.restore(str(tmp_path), 1, params, opt)
    p2, o2, extra = checkpoint.restore(str(tmp_path), 1, params, opt,
                                       shardings=tsh.param_shardings(params, tmesh),
                                       opt_shardings=tsh.opt_state_shardings(opt, tmesh))
    assert extra == {"next_step": 1}
    assert isinstance(p2["layers"][0]["mlp"]["w_gate"], DTensor)
    assert len(p2["layers"]) == cfg.n_layers and list(p2) == list(params)
    for a, b in zip(tree_leaves(p1) + tree_leaves(o1.m) + tree_leaves(o1.v) + [o1.step],
                    tree_leaves(p2) + tree_leaves(o2.m) + tree_leaves(o2.v) + [o2.step]):
        assert isinstance(b, DTensor)
        full = b.full_tensor()
        assert full.dtype == a.dtype and torch.equal(full, a)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    # the model has no tensor-parallel form: the loss runs on the gathered params
    l2 = TM.loss_fn(tree_map(lambda t: t.full_tensor(), p2), batch, cfg)
    assert torch.equal(l2, TM.loss_fn(p1, batch, cfg))

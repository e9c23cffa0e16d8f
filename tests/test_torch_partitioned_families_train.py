"""The partitioned train step of gemma2-27b, internvl2-2b and
seamless-m4t-large-v2 against the JAX package's unsharded one, on the CPU
over a real two-rank ``gloo`` group.

* ``train.train_step.train_step_`` with ``mesh=`` for the three smoke
  configs in f32 with ``remat=True`` (gemma2's tied head, softcaps,
  post-norms and local window; internvl2-2b's image prefix, dropped before
  the loss; seamless's encoder over the frames and the decoder's cross
  attention), and ``gemma2-27b+sp`` (``seq_parallel=True``, its post-norm
  scales partial over ``model``) on (1, 2), on meshes (data, model) = (1,
  2) and (2, 1): a global batch of 8 x 16 tokens (internvl2-2b behind a
  4-row prefix, seamless over 16 frames), ``accum`` 2, two steps.
  internvl2-2b and seamless run with ``vocab_size=257`` on both sides:
  GSPMD's padded vocab (the embedding's rows and the head's columns padded
  to 258, the pad masked out of the loss). Each step's loss and
  ``grad_norm`` match ``repro.train.train_step.train_step`` on the same
  numpy params and batch to ``rtol=1e-5`` on every rank; the params and
  moments gathered back (``dist.sharding.full_tree``, the pad stripped)
  match to ``rtol=1e-5`` with an atol of 1e-5 x the leaf's max |x|.
* Counts: each rank's ``CollectiveCounter`` totals equal the ``meta``
  count of the same steps over a ``fake`` group; no kernel launches; each
  rank holds the params and moments its ZeRO-1 plan gives it (the padded
  shapes).
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.dist import sharding as shard_lib  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import partitioned  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ARCHS = ["gemma2-27b", "internvl2-2b", "seamless-m4t-large-v2"]
CASES = ARCHS + ["gemma2-27b+sp"]
MESHES = [(1, 2), (2, 1)]
PADDED_VOCAB = 257
B, S, ACCUM, STEPS = 8, 16, 2, 2
RTOL, ATOL_OF_MAX = 1e-5, 1e-5


def _configs(case):
    arch = case.split("+")[0]
    jcfg = get_config(arch, smoke=True).replace(dtype="float32", param_dtype="float32",
                                               remat=True)
    if jcfg.family in ("vlm", "audio"):
        jcfg = jcfg.replace(vocab_size=PADDED_VOCAB)
    tcfg = ModelConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    return jcfg, tcfg.replace(seq_parallel=case.endswith("+sp"))


def _batch(jcfg) -> dict:
    r = np.random.default_rng(4)
    out = {k: r.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
           for k in ("tokens", "labels")}
    if jcfg.family == "vlm":
        out["prefix_embeds"] = r.standard_normal(
            (B, jcfg.n_prefix_tokens, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "audio":
        out["src_frames"] = r.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    return out


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
    path)."""
    out = {}
    opt = jopt.AdamWConfig(**dataclasses.asdict(partitioned.TRAIN_OPT))
    for arch in ARCHS:
        jcfg, _ = _configs(arch)
        jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
        batch = _batch(jcfg)
        params, state, metrics = jp, jopt.init_opt_state(jp), []
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        step = jax.jit(lambda p, s, b, c=jcfg: jstep.train_step(p, s, b, c, opt, ACCUM))
        for _ in range(STEPS):
            params, state, m = step(params, state, jb)
            metrics.append({k: float(v) for k, v in m.items()})
        out[arch] = (jax.tree_util.tree_map(np.asarray, jp), batch, metrics,
                     _by_path(params), _by_path(state.m), _by_path(state.v))
    return out


@pytest.fixture(scope="module")
def ranks(jax_runs):
    """Every case on both meshes of one two-rank group (the in-place step),
    each rank's results in rank order."""
    jobs = [(_configs(case)[1], *jax_runs[case.split("+")[0]][:2]) for case in CASES]
    return tmesh.spawn(partitioned.train_run, 2, jobs, MESHES, STEPS, ACCUM, "cpu")


def _case_mesh():
    return [(case, shape) for case in CASES for shape in MESHES
            if not (case.endswith("+sp") and shape != (1, 2))]


def _runs(ranks, case, shape):
    return [r[CASES.index(case)][MESHES.index(shape)] for r in ranks]


@pytest.mark.parametrize("case,shape", _case_mesh())
def test_partitioned_family_train_step_matches_jax(ranks, jax_runs, case, shape):
    jmetrics, jparams, jm, jv = jax_runs[case.split("+")[0]][2:]
    runs = _runs(ranks, case, shape)
    for r in runs:
        assert len(r["metrics"]) == STEPS
        for got, want in zip(r["metrics"], jmetrics):
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=(k, r["coords"]))
        assert r["metrics"] == runs[0]["metrics"], r["coords"]   # the same on every rank
    for name, want in (("params", jparams), ("m", jm), ("v", jv)):
        got = runs[0][name]
        assert set(got) == set(want)
        for path, w in want.items():
            assert got[path].shape == w.shape, (name, path)     # the pad stripped
            np.testing.assert_allclose(got[path], w, rtol=RTOL,
                                       atol=ATOL_OF_MAX * float(np.abs(w).max()),
                                       err_msg=f"{name} {path}")


@pytest.mark.parametrize("shape", MESHES)
def test_family_train_counts_meta_equal_gloo(ranks, shape):
    """Kind by kind, every gloo rank's count equals the meta count over a
    fake group; no launches; the rank's params and moments are the bytes of
    its ZeRO-1 plan's shapes (a padded vocab's included)."""
    for case in CASES:
        if case.endswith("+sp") and shape != (1, 2):
            continue
        jcfg, cfg = _configs(case)
        batch = _batch(jcfg)
        extra = {k: v.shape for k, v in batch.items() if k not in ("tokens", "labels")}
        meta = partitioned.count_train_run(cfg, shape, B, S, STEPS, ACCUM, extra)
        with tmesh.counting_mesh(shape, partitioned.AXES) as m:
            plan = shard_lib.zero1_plan(cfg, m)
        params = sum(4 * math.prod(z.param_shape) for z in plan.values())
        moments = 2 * sum(4 * math.prod(z.moment_shape) for z in plan.values())
        for r in _runs(ranks, case, shape):
            assert r["collectives"] == meta, (case, r["coords"])
            assert not any(r["launches"].values())   # the CPU runs the plain versions
            assert (r["param_bytes"], r["moment_bytes"]) == (params, moments), case
        if shape[-1] > 1:
            assert meta["_counts"]["reduce-scatter"] > 0     # the K/V gathers' backward
        else:
            assert meta["_counts"]["all-gather"] > 0         # the params back to the data ranks
        if cfg.family == "vlm" and shape[-1] > 1:
            assert plan["embed/w"].param_shape[0] == math.ceil(PADDED_VOCAB / shape[-1])


def test_partial_over_model_takes_the_post_norms_under_sequence_parallelism():
    """gemma2's post-norm scales act on the rank's share of the sequence, so
    their gradients are partial over ``model`` under ``seq_parallel``; the
    audio stacks take no sequence split (the JAX package constrains the
    dense block only), so nothing is partial there."""
    gemma = _configs("gemma2-27b+sp")[1]
    audio = _configs("seamless-m4t-large-v2")[1].replace(seq_parallel=True)
    with tmesh.counting_mesh((1, 2), partitioned.AXES) as m:
        assert TM.partial_over_model(gemma, m, S) == (
            "layers/attn_norm/scale", "layers/mlp_norm/scale", "layers/post_attn_norm/scale",
            "layers/post_mlp_norm/scale", "final_norm/scale")
        assert TM.partial_over_model(gemma, m, 8) == ()
        assert TM.partial_over_model(audio, m, S) == ()
        assert not TM.train_parallel(audio, m, S).seq

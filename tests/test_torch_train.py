"""The port's training path (``repro_torch.train``) against the JAX package,
on the CPU at f32 smoke sizes.

The data copy's batches and the lr schedule against the originals; one
AdamW step; ``tests/test_train.py``'s contracts run on the port (loss
decreases, crash-resume replay, quarantine, accumulation, data determinism
and host sharding, the schedule's shape); checkpoints restoring across the
two packages; the port's import isolation. Gradients against
``jax.value_and_grad`` are in ``test_torch_grads.py``. ``test_train.py``'s ``test_elastic_reshard_on_restore`` needs a
device mesh, which belongs to ROADMAP A.10c, and is not ported here.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.train.loop import TrainConfig, run  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    AdamWConfig, OptState, adamw_update, init_opt_state, lr_at, tree_leaves, tree_map)
from repro_torch.train.train_step import train_step, value_and_grad  # noqa: E402
from test_torch_forward import carried_params, f32_pair, numpy_batch, to_torch  # noqa: E402

RTOL, ATOL_OF_MAX = 1e-4, 1e-5
QUIET = dict(log=lambda *a: None, device="cpu")


def jax_leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_leaves(tree) -> dict:
    """A port tree in the JAX layout, keyed as :func:`jax_leaves` keys it."""
    return jax_leaves(TM.params_to_numpy(tree))


def assert_trees_close(got: dict, want: dict, rtol=RTOL):
    """Every leaf within ``rtol`` and an atol of 1e-5 of the leaf's max |x|."""
    assert set(got) == set(want)
    for k, w in want.items():
        atol = ATOL_OF_MAX * float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol, err_msg=k)


def assert_trees_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _dc(vocab: int) -> DataConfig:
    return DataConfig(vocab_size=vocab, seq_len=32, global_batch=4)


@pytest.fixture(scope="module")
def cfg():
    return t_get_config("llama3-8b", smoke=True)


def test_data_copy_equals_jax():
    for dc in (DataConfig(vocab_size=256, seq_len=64, global_batch=4, seed=3),
               DataConfig(vocab_size=32000, seq_len=33, global_batch=8, n_hosts=2, host_id=1)):
        ours, theirs = SyntheticLM(dc), jdata.SyntheticLM(jdata.DataConfig(
            **dataclasses.asdict(dc)))
        for step in (0, 1, 7, 1000):
            a, b = ours.batch_at(step), theirs.batch_at(step)
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_lr_at_equals_jax():
    for c in (AdamWConfig(), AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100),
              AdamWConfig(lr=6e-4, warmup_steps=1, total_steps=2)):
        jc = jopt.AdamWConfig(**dataclasses.asdict(c))
        for step in (0, 1, 2, 5, 10, 11, 50, 99, 100, 150, 9999):
            np.testing.assert_allclose(float(lr_at(step, c)), float(jopt.lr_at(step, jc)),
                                       rtol=1e-6)


def test_adamw_update_equals_jax():
    """One AdamW step from a state with moments (step 3, clipping active):
    params, ``m``, ``v``, ``lr`` and ``grad_norm`` against the JAX update."""
    jcfg, _ = f32_pair("llama3-8b")
    jp, tp = carried_params(jcfg)
    r = np.random.default_rng(5)

    def like(scale):
        return jax.tree_util.tree_map(
            lambda a: (scale * r.standard_normal(a.shape)).astype(np.float32), jp)

    g, m, v = like(1.0), like(0.1), jax.tree_util.tree_map(np.abs, like(0.01))
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10, clip_norm=0.5)
    jnew, jstate, jstats = jax.jit(jopt.adamw_update, static_argnums=3)(
        jp, g, jopt.OptState(step=jnp.int32(3), m=m, v=v),
        jopt.AdamWConfig(**dataclasses.asdict(c)))

    def port(tree):
        return TM.params_from_numpy(tree, device="cpu")

    new, state, stats = adamw_update(
        tp, port(g), OptState(step=torch.tensor(3, dtype=torch.int32), m=port(m), v=port(v)), c)
    assert int(state.step) == 4 and state.step.dtype == torch.int32
    np.testing.assert_allclose(float(stats["grad_norm"]), float(jstats["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(stats["lr"]), float(jstats["lr"]), rtol=1e-6)
    for got, want in ((new, jnew), (state.m, jstate.m), (state.v, jstate.v)):
        assert_trees_close(port_leaves(got), jax_leaves(want), rtol=1e-6)


def test_bf16_step_keeps_dtypes_and_updates_in_f32(cfg):
    """A bf16 train step (the smoke config's own dtypes, remat on): params
    stay bf16, the moments are f32, and the loss is finite."""
    params = TM.init_params(cfg.replace(remat=True), torch.Generator().manual_seed(0),
                            device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(_dc(cfg.vocab_size))
             .batch_at(0).items()}
    new, state, metrics = train_step(params, init_opt_state(params), batch,
                                     cfg.replace(remat=True), AdamWConfig(), 1)
    assert np.isfinite(float(metrics["loss"]))
    assert {t.dtype for t in tree_leaves(new)} == {torch.bfloat16}
    assert {t.dtype for t in tree_leaves(state.m) + tree_leaves(state.v)} == {torch.float32}
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(new), tree_leaves(params)))


# --- tests/test_train.py's contracts, on the port ---------------------------


def test_loss_decreases(cfg):
    tc = TrainConfig(steps=12, log_every=0,
                     opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12))
    _, _, hist = run(cfg, _dc(cfg.vocab_size), tc, **QUIET)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_crash_resume_exact_replay(cfg, tmp_path):
    """Stopped at step 6 and restarted, the run ends with the params of the
    uninterrupted one."""
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    p_full, _, _ = run(cfg, _dc(cfg.vocab_size),
                       TrainConfig(steps=10, ckpt_dir=str(tmp_path / "a"), ckpt_every=100,
                                   opt=opt), **QUIET)
    d2 = str(tmp_path / "b")
    run(cfg, _dc(cfg.vocab_size), TrainConfig(steps=6, ckpt_dir=d2, ckpt_every=3, opt=opt),
        **QUIET)
    p_res, _, hist = run(cfg, _dc(cfg.vocab_size),
                         TrainConfig(steps=10, ckpt_dir=d2, ckpt_every=3, opt=opt), **QUIET)
    assert hist[0]["step"] == 6  # resumed, not restarted
    for a, b in zip(tree_leaves(p_full), tree_leaves(p_res)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=2e-2, atol=1e-3)


def test_corrupted_checkpoint_quarantined(cfg, tmp_path):
    d = str(tmp_path / "c")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = init_opt_state(params)
    checkpoint.save(d, 5, params, opt, extra={"next_step": 5})
    checkpoint.save(d, 10, params, opt, extra={"next_step": 10})
    os.remove(os.path.join(d, "step_00000010", "arrays.npz"))
    assert checkpoint.latest_step(d) == 5  # falls back
    assert os.path.exists(os.path.join(d, "step_00000010.bad"))  # quarantined


def test_accum_matches_full_batch_loss(cfg):
    """accum=2 gives the full batch's loss (the mean of its microbatches')."""
    batch = {k: torch.from_numpy(v)
             for k, v in SyntheticLM(_dc(cfg.vocab_size)).batch_at(0).items()}
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = AdamWConfig(lr=0.0, weight_decay=0.0, warmup_steps=1, total_steps=2)
    _, _, m1 = train_step(params, init_opt_state(params), batch, cfg, opt, 1)
    _, _, m2 = train_step(params, init_opt_state(params), batch, cfg, opt, 2)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 2e-2


def test_accum_grads_are_the_microbatch_mean():
    """At f32 the accumulated step's update equals one over the mean of the
    two microbatches' gradients."""
    _, cfg = f32_pair("llama3-8b")
    batch = to_torch(numpy_batch(cfg, 4, 16))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    halves = [{k: v[i:i + 2] for k, v in batch.items()} for i in (0, 2)]
    (l0, g0), (l1, g1) = (value_and_grad(params, h, cfg) for h in halves)
    opt = AdamWConfig(warmup_steps=1, total_steps=4)
    want, _, _ = adamw_update(params, tree_map(lambda a, b: (a + b) / 2, g0, g1),
                              init_opt_state(params), opt)
    got, _, metrics = train_step(params, init_opt_state(params), batch, cfg, opt, 2)
    np.testing.assert_allclose(float(metrics["loss"]), float((l0 + l1) / 2), rtol=1e-6)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)


def test_data_determinism_and_host_sharding():
    dc = DataConfig(vocab_size=1000, seq_len=64, global_batch=8, n_hosts=2, host_id=0)
    d0 = SyntheticLM(dc)
    d0b = SyntheticLM(dc)
    np.testing.assert_array_equal(d0.batch_at(7)["tokens"], d0b.batch_at(7)["tokens"])
    d1 = SyntheticLM(DataConfig(vocab_size=1000, seq_len=64, global_batch=8,
                                n_hosts=2, host_id=1))
    assert not np.array_equal(d0.batch_at(7)["tokens"], d1.batch_at(7)["tokens"])
    assert d0.batch_at(7)["tokens"].shape == (4, 64)  # local shard


def test_lr_schedule_shape():
    c = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert float(lr_at(0, c)) < float(lr_at(10, c))
    assert float(lr_at(10, c)) == pytest.approx(1e-3, rel=1e-3)
    assert float(lr_at(100, c)) == pytest.approx(1e-4, rel=1e-2)


def test_non_finite_loss_raises(cfg):
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params["final_norm"]["scale"] = torch.full_like(params["final_norm"]["scale"], float("nan"))
    with pytest.raises(FloatingPointError, match="step 0"):
        run(cfg, _dc(cfg.vocab_size), TrainConfig(steps=2, log_every=0), params=params, **QUIET)


# --- checkpoints across the two packages ------------------------------------


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-7b", "seamless-m4t-large-v2"])
def test_checkpoints_restore_across_packages(arch, tmp_path):
    """bf16 params (the smoke config's own dtype) and a moved optimizer
    state: a JAX checkpoint restores in the port and a port checkpoint in
    JAX, leaf for leaf, with the manifest's ``extra``."""
    jcfg = get_config(arch, smoke=True)
    jp = jax.jit(functools.partial(JM.init_params, cfg=jcfg))(jax.random.PRNGKey(0))
    r = np.random.default_rng(6)
    jo = jopt.OptState(step=jnp.int32(7),
                       m=jax.tree_util.tree_map(
                           lambda a: r.standard_normal(a.shape).astype(np.float32), jp),
                       v=jax.tree_util.tree_map(
                           lambda a: r.random(a.shape).astype(np.float32), jp))
    jckpt.save(str(tmp_path / "jax"), 7, jp, jo, extra={"next_step": 7})

    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    like = TM.init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    assert checkpoint.latest_step(str(tmp_path / "jax")) == 7
    tp, to, extra = checkpoint.restore(str(tmp_path / "jax"), 7, like, init_opt_state(like))
    assert extra == {"next_step": 7} and int(to.step) == 7
    assert tree_leaves(tp)[0].dtype == torch.bfloat16
    for got, want in ((tp, jp), (to.m, jo.m), (to.v, jo.v)):
        assert_trees_equal(port_leaves(got), jax_leaves(want))

    checkpoint.save(str(tmp_path / "port"), 9, tp, to._replace(step=torch.tensor(
        9, dtype=torch.int32)), extra={"next_step": 9})
    jp2, jo2, jextra = jckpt.restore(str(tmp_path / "port"), 9, jp,
                                     jopt.init_opt_state(jp))
    assert jextra == {"next_step": 9} and int(jo2.step) == 9
    assert jax.tree_util.tree_structure(jp2) == jax.tree_util.tree_structure(jp)
    for got, want in ((jp2, jp), (jo2.m, jo.m), (jo2.v, jo.v)):
        assert_trees_equal(jax_leaves(got), jax_leaves(want))


def test_the_port_imports_no_jax_and_nothing_of_repro():
    """Every module of ``repro_torch`` (the training path included) and
    ``chip_smoke.py`` import with ``jax`` and ``repro`` made unimportable."""
    root = Path(__file__).resolve().parents[1]
    code = (
        "import importlib, pkgutil, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "tools = {'repro_torch.launch.' + t for t in ('dryrun', 'costrun', 'roofline',\n"
        "                                             'hillclimb', 'mesh')}\n"
        "assert tools | {'repro_torch.kernels.work'} <= set(names), names\n"
        "import torch.distributed\n"
        "assert not torch.distributed.is_initialized()   # importing starts no group\n"
        "import chip_smoke\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root / "src"), str(root)]))
    subprocess.run([sys.executable, "-c", code], env=env, cwd=root, check=True, timeout=300)

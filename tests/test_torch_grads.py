"""Autograd on the port against ``jax.value_and_grad``, on the CPU at f32
smoke sizes: the loss and every gradient leaf of ``loss_fn`` for one arch of
every family (gemma2-27b for the tied head, softcaps and windows), compared
through ``params_to_numpy`` in the JAX layout; per-layer rematerialisation;
and the Mamba2 decay's deliberate difference (ROADMAP C). The optimizer, the
loop, checkpoints and ``tests/test_train.py``'s contracts are in
``test_torch_train.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import model as JM  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402
from test_torch_forward import carried_params, f32_pair, numpy_batch, to_jax, to_torch  # noqa: E402
from test_torch_train import assert_trees_close, jax_leaves, port_leaves  # noqa: E402

FAMILY_ARCHS = ["llama3-8b", "gemma2-27b", "internvl2-2b", "olmoe-1b-7b", "rwkv6-1.6b",
                "zamba2-7b", "seamless-m4t-large-v2"]
# one jitted JAX loss-and-grads: a second call at the same config and shapes reuses it
jax_value_and_grad = jax.jit(jax.value_and_grad(JM.loss_fn), static_argnums=2)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_grads_equal_jax_value_and_grad(arch):
    """Loss and every gradient leaf of ``loss_fn``, autograd against
    ``jax.value_and_grad``, through ``params_to_numpy`` (the JAX layout)."""
    jcfg, tcfg = f32_pair(arch)
    jp, tp = carried_params(jcfg)
    batch = numpy_batch(jcfg, 2, 16)
    jloss, jgrads = jax_value_and_grad(jp, to_jax(batch), jcfg)
    loss, grads = value_and_grad(tp, to_torch(batch), tcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_trees_close(port_leaves(grads), jax_leaves(jgrads))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_gives_the_same_grads(arch):
    """Each layer (a hybrid group) recomputed in the backward pass under
    ``cfg.remat``: the same loss and gradients, bit for bit."""
    _, cfg = f32_pair(arch)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = to_torch(numpy_batch(cfg, 2, 16))
    l0, g0 = value_and_grad(params, batch, cfg.replace(remat=False))
    l1, g1 = value_and_grad(params, batch, cfg.replace(remat=True))
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_mamba2_grads_finite_where_the_jax_decay_overflows():
    """A deliberate difference (ROADMAP C): on these weights some chunk's
    log decays sum past f32's exp range, and JAX's ``ssd_chunked``, which
    takes exp above the diagonal before masking it, gives NaN gradients.
    The port masks the log decays first: the same loss, finite gradients."""
    jcfg, cfg = f32_pair("zamba2-7b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = numpy_batch(cfg, 2, 16)
    jloss, jgrads = jax_value_and_grad(
        jax.tree_util.tree_map(jnp.asarray, TM.params_to_numpy(params)), to_jax(batch), jcfg)
    assert any(np.isnan(np.asarray(g)).any() for g in jax.tree_util.tree_leaves(jgrads))
    loss, grads = value_and_grad(params, to_torch(batch), cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))

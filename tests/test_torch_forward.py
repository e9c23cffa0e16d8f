"""The port's full-sequence model path against the JAX package, on the CPU at
f32 smoke sizes.

``forward`` and ``loss_fn`` for all ten archs on ``test_models.py``'s batch
shapes (with the vlm image prefix and the audio source frames), made with
numpy from a seed and fed to both sides; the port's own teacher-forcing
invariant (prefill then decode equals the full forward); the causal block
skip; the causal ``attention_dense`` itself (windows, ragged tail, K/V out);
the hybrid ``prefill`` (logits and every cache leaf) and the MoE
load-balance loss. Gradients and the train step are in
``test_torch_train.py``.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, list_archs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

ARCHS = list_archs()
HIDDEN_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5


def f32_pair(arch: str, **over):
    jcfg = get_config(arch, smoke=True).replace(dtype="float32", param_dtype="float32",
                                                **over)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def carried_params(jcfg, seed: int = 0):
    """JAX's ``init_params`` (jitted: eager init of a stacked tree is slow)
    and the same weights carried over to the port (shared: never written)."""
    jp = jax.jit(functools.partial(JM.init_params, cfg=jcfg))(jax.random.PRNGKey(seed))
    return jp, TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def numpy_batch(cfg, b: int, s: int, seed: int = 1, src_len=None) -> dict:
    """``test_models.py``'s batch shapes from a numpy seed: tokens doubling
    as labels, the vlm prefix, the audio frames (``src_len`` of them)."""
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = (0.02 * r.standard_normal(
            (b, cfg.n_prefix_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "audio":
        batch["src_frames"] = (0.02 * r.standard_normal(
            (b, src_len or s, cfg.d_model))).astype(np.float32)
    return batch


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_equal_jax(arch):
    jcfg, tcfg = f32_pair(arch)
    jp, tp = carried_params(jcfg)
    batch = numpy_batch(jcfg, 2, 16)
    jx, jloss = jax.jit(lambda p, b: (JM.forward(p, b, jcfg), JM.loss_fn(p, b, jcfg)))(
        jp, to_jax(batch))
    tb = to_torch(batch)
    tx = TM.forward(tp, tb, tcfg)
    assert tx.shape == (2, 16, jcfg.d_model)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **HIDDEN_TOL)
    np.testing.assert_allclose(float(TM.loss_fn(tp, tb, tcfg)), float(jloss), rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    """The teacher-forcing invariant of ``test_models.py``, inside the port:
    prefill the first 8 tokens, decode 4, each step's logits within 2e-3 of
    the full forward's (no capacity drops: factor 16, as there)."""
    _, cfg = f32_pair(arch, moe_capacity_factor=16.0)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    s, split = 12, 8
    batch = to_torch(numpy_batch(cfg, 2, s, src_len=24))
    ref = TM.logits_fn(params, TM.forward(params, batch, cfg), cfg)
    kw = {}
    if cfg.family == "vlm":
        kw["prefix_embeds"] = batch["prefix_embeds"]
    if cfg.family == "audio":
        kw["src_frames"] = batch["src_frames"]
    toks = batch["tokens"]
    logits, cache = TM.prefill(params, toks[:, :split], cfg, max_len=32, **kw)
    errs = [float((logits[:, 0] - ref[:, split - 1]).abs().max())]
    for i in range(split, s):
        logits, cache = TM.decode_step(params, cache, toks[:, i:i + 1], cfg)
        errs.append(float((logits[:, 0] - ref[:, i]).abs().max()))
    assert max(errs) < 2e-3, f"{arch}: decode diverges from forward by {max(errs)}"


def test_causal_block_skip_matches_full():
    """``test_beyond_paper.py``'s case: 4-query chunks over 16 tokens read
    only their visible key prefix, and agree with reading every key."""
    _, cfg = f32_pair("llama3-8b", q_chunk=4)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = to_torch(numpy_batch(cfg, 2, 16))
    x1 = TM.forward(params, batch, cfg.replace(causal_block_skip=True))
    x2 = TM.forward(params, batch, cfg.replace(causal_block_skip=False))
    assert float((x1 - x2).abs().max()) < 1e-5


@pytest.mark.parametrize("t,window,causal,skip", [
    (16, None, True, True), (16, 6, True, True), (16, 6, True, False), (12, None, True, True),
    (16, None, False, True)], ids=["causal", "window", "window-noskip", "ragged", "bidir"])
def test_attention_dense_equals_jax(t, window, causal, skip):
    """One layer's attention: 8-query chunks (12 tokens: the ragged tail runs
    as one chunk), a sliding window, bidirectional, shifted RoPE positions,
    the returned K/V; gemma2's softcap."""
    jcfg, tcfg = f32_pair("gemma2-27b", causal_block_skip=skip)
    jp, tp = carried_params(f32_pair("gemma2-27b")[0])
    x = np.random.default_rng(3).standard_normal((2, t, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t) + 5, (2, t)).astype(np.int32)
    jy, (jk, jv) = jattn.attention_dense(
        jax.tree_util.tree_map(lambda a: a[0], jp["layers"])["attn"], jnp.asarray(x), jcfg,
        window=window, causal=causal, positions=jnp.asarray(pos), return_kv=True)
    ty, (tk, tv) = tattn.attention_dense(tp["layers"][0]["attn"], torch.from_numpy(x), tcfg,
                                         window=window, causal=causal,
                                         positions=torch.from_numpy(pos), return_kv=True)
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **HIDDEN_TOL)


@pytest.mark.parametrize("seq_lens", [None, [16, 11]], ids=["full", "ragged"])
def test_hybrid_prefill_equals_jax(seq_lens):
    """zamba2's ``prefill``: the full-sequence hybrid forward from zero state
    (two shared-block applications and a trailing Mamba2 layer), the last
    logits (each row's own under ``seq_lens``), every Mamba2 layer's state
    and each application's K/V in the lanes, ``pos``."""
    jcfg, tcfg = f32_pair("zamba2-7b")
    jp, tp = carried_params(jcfg)
    toks = numpy_batch(jcfg, 2, 16)["tokens"]
    jl, jc = jax.jit(functools.partial(JM.prefill, cfg=jcfg, max_len=24, seq_lens=seq_lens))(
        jp, {"tokens": jnp.asarray(toks)})
    tl, tc = TM.prefill(tp, torch.from_numpy(toks), tcfg, max_len=24, seq_lens=seq_lens)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **HIDDEN_TOL)
    assert set(tc) == set(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), err_msg=k, **HIDDEN_TOL)


def test_aux_load_balance_loss_equals_jax_and_uniform_is_one():
    jcfg, tcfg = f32_pair("olmoe-1b-7b")
    jp, tp = carried_params(jcfg)
    x = np.random.default_rng(4).standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    jrouter = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])["moe"]
    want = float(jmoe.aux_load_balance_loss(jrouter, jnp.asarray(x), jcfg))
    got = tmoe.aux_load_balance_loss(tp["layers"][0]["moe"], torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    tmoe_p = tp["layers"][0]["moe"]
    uniform = dict(tmoe_p, router=torch.zeros_like(tmoe_p["router"]))
    assert float(tmoe.aux_load_balance_loss(uniform, torch.from_numpy(x), tcfg)) == \
        pytest.approx(1.0, rel=1e-6)

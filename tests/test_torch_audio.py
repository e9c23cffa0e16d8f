"""The port's seamless-m4t-large-v2 (``family="audio"``) against the JAX
package, on the CPU at an f32 smoke size; and the cache-state specs and
admission policy of every registered arch.

The encoder-decoder runs at model level only, as in the JAX package: the
config copy and the ``enc_layers``/``dec_layers`` weight stacks; the
bidirectional encoder, the per-layer cross K/V of its memory, ``prefill``
with ``src_frames`` (logits, self-KV, cross K/V) and per-step
``decode_step`` with W8A8 on and off; the int8 images cover the decoder's
self attention and MLP but not the encoder or the cross attention; and an
audio serve fails at admission in both engines (the admission passes no
source frames).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs import list_archs as j_list_archs  # noqa: E402
from repro.core.quant import PreparedLinear as JPrepared  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import cache as jcache  # noqa: E402
from repro.serve.api import GenerationRequest as JReq  # noqa: E402
from repro.serve.serving_model import ServingModel as JServing  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.core.quant import PreparedLinear  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import cache as tcache  # noqa: E402
from repro_torch.serve.api import GenerationRequest  # noqa: E402
from repro_torch.serve.serving_model import ServingModel  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SRC = 11        # source frames: not a multiple of the smoke q_chunk (8), one chunk
MAX_LEN = 24


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    jcfg = get_config("seamless-m4t-large-v2", smoke=True).replace(dtype="float32",
                                                                    param_dtype="float32")
    jp = jax.jit(functools.partial(JM.init_params, cfg=jcfg))(jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    yield jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jp, tp
    jax.clear_caches()


def _frames(jcfg, b=2, s=SRC, seed=2):
    r = np.random.default_rng(seed)
    return r.standard_normal((b, s, jcfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_copy_matches_jax(smoke):
    assert dataclasses.asdict(t_get_config("seamless-m4t-large-v2", smoke=smoke)) == \
        dataclasses.asdict(get_config("seamless-m4t-large-v2", smoke=smoke))
    full = t_get_config("seamless-m4t-large-v2")
    assert (full.family, full.n_encoder_layers, full.n_layers, full.q_per_kv,
            full.head_dim, full.vocab_size) == ("audio", 24, 24, 1, 64, 256206)


def test_params_tree_matches_jax(models):
    """Both stacks split per layer bit for bit; a fresh torch init has JAX's
    tree (the decoder layers' cross norm and cross attention included)."""
    jcfg, tcfg, jp, tp = models
    for key, n in (("enc_layers", jcfg.n_encoder_layers), ("dec_layers", jcfg.n_layers)):
        assert len(tp[key]) == n
        for path, leaf in jax.tree_util.tree_flatten_with_path(jp[key])[0]:
            for i in range(n):
                node = tp[key][i]
                for k in path:
                    node = node[k.key]
                np.testing.assert_array_equal(node.numpy(), np.asarray(leaf)[i])
    fresh = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(fresh) == set(tp) == set(jp)
    assert set(fresh["dec_layers"][0]) == set(tp["dec_layers"][0]) == \
        {"attn_norm", "attn", "mlp_norm", "mlp", "cross_norm", "cross_attn"}
    assert set(fresh["enc_layers"][0]) == {"attn_norm", "attn", "mlp_norm", "mlp"}


def test_encoder_and_cross_kv_vs_jax(models):
    jcfg, tcfg, jp, tp = models
    fr = _frames(jcfg)
    jmem = JM._audio_encode(jp, jnp.asarray(fr), jcfg)
    tmem = TM._audio_encode(tp, t(fr), tcfg)
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), **TOL)
    jk, jv = JM.project_cross_kv(jp, jmem, jcfg)
    tk, tv = TM.project_cross_kv(tp, t(np.asarray(jmem)), tcfg)
    assert tuple(tk.shape) == jk.shape == (jcfg.n_layers, 2, jcfg.n_kv_heads, SRC,
                                           jcfg.head_dim)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_encoder_attention_is_bidirectional(models):
    """The encoder's attention reads later frames too: changing the last
    frame moves the first frame's memory."""
    _, tcfg, _, tp = models
    fr = t(_frames(tcfg))
    fr2 = fr.clone()
    fr2[:, -1] += 1.0
    a, b = TM._audio_encode(tp, fr, tcfg), TM._audio_encode(tp, fr2, tcfg)
    assert not torch.allclose(a[:, 0], b[:, 0])


@pytest.mark.parametrize("bos", [1, 3])
def test_prefill_vs_jax(models, bos):
    jcfg, tcfg, jp, tp = models
    fr = _frames(jcfg)
    toks = np.random.default_rng(3).integers(1, jcfg.vocab_size, (2, bos)).astype(np.int32)
    jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks), "src_frames": jnp.asarray(fr)},
                        jcfg, MAX_LEN)
    tl, tc = TM.prefill(tp, t(toks).long(), tcfg, MAX_LEN, src_frames=t(fr))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert set(tc) == set(jc) and int(tc["pos"]) == int(jc["pos"]) == bos
    for k in ("k", "v", "cross_k", "cross_v"):
        assert tuple(tc[k].shape) == jc[k].shape, k
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)


def test_prefill_requires_src_frames(models):
    """The JAX package fails with a KeyError on the missing frames; the port
    names them in a ValueError."""
    jcfg, tcfg, jp, tp = models
    toks = np.ones((1, 1), np.int32)
    with pytest.raises(KeyError, match="src_frames"):
        JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, MAX_LEN)
    with pytest.raises(ValueError, match="src_frames"):
        TM.prefill(tp, t(toks).long(), tcfg, MAX_LEN)


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_steps_vs_jax(models, quantized):
    """Greedy steps after a prefill of one BOS token, on each package's
    prepared artifact (int8 images of the decoder's q/k/v/o and MLP under
    W8A8): logits, tokens and the self-KV lanes; the encoder memory is read,
    never written. Each step starts both sides from the JAX cache."""
    jcfg, tcfg, jp, tp = models
    jcfg, tcfg = (c.replace(quantized_decode=quantized) for c in (jcfg, tcfg))
    jsm = JServing.prepare(jcfg, jp, max_len=MAX_LEN, slots=2)
    tsm = ServingModel.prepare(tcfg, tp, max_len=MAX_LEN, slots=2, device="cpu")
    assert tsm.prequantized == jsm.prequantized == quantized
    fr = _frames(jcfg)
    bos = np.ones((2, 1), np.int32)
    jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(bos), "src_frames": jnp.asarray(fr)},
                        jcfg, MAX_LEN)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(4):
        tc = {k: t(v) for k, v in jc.items()}
        cross = tc["cross_k"].clone()
        k_before = tc["k"]
        jl, jc = JM.decode_step(jsm.decode_params, jc, jnp.asarray(tok), jcfg)
        tl, tc = TM.decode_step(tsm.decode_params, tc, t(tok).long(), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
        assert tc["k"] is k_before and torch.equal(tc["cross_k"], cross)
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-4, atol=1e-5)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)


def test_prequantize_skips_prefill_only_subtrees(models):
    """The JAX gate (``test_serving_api.py``): the decoder's self attention
    and MLP carry int8 images, bit-equal to JAX's; the encoder and the cross
    attention stay float."""
    jcfg, tcfg, jp, tp = models
    jsm = JServing.prepare(jcfg.replace(quantized_decode=True), jp, max_len=MAX_LEN, slots=2)
    sm = ServingModel.prepare(tcfg.replace(quantized_decode=True), tp, max_len=MAX_LEN,
                              slots=2, device="cpu")
    dp, jdp = sm.decode_params, jsm.decode_params
    for i in range(tcfg.n_layers):
        for sub, name in (("attn", "wq"), ("attn", "wo"), ("mlp", "w_down")):
            leaf = dp["dec_layers"][i][sub][name]
            assert isinstance(leaf, PreparedLinear)
            np.testing.assert_array_equal(leaf.w_q.numpy(),
                                          np.asarray(jdp["dec_layers"][sub][name].w_q)[i])
        cross, float_cross = dp["dec_layers"][i]["cross_attn"], tp["dec_layers"][i]["cross_attn"]
        for name in ("wq", "wk", "wv", "wo"):
            assert cross[name] is float_cross[name]
            assert not isinstance(jdp["dec_layers"]["cross_attn"][name], JPrepared)
    for lp in dp["enc_layers"]:
        assert not any(isinstance(v, PreparedLinear) for sub in ("attn", "mlp")
                       for v in lp[sub].values())


def test_audio_serve_fails_at_admission_in_both_engines(models):
    """Neither engine serves audio: admission runs no encoder (it has no
    source frames), so the first admission fails."""
    jcfg, tcfg, jp, tp = models
    jeng = JServing.prepare(jcfg, jp, max_len=MAX_LEN, slots=2).engine(chunk=4)
    with pytest.raises(KeyError, match="src_frames"):
        jeng.serve([JReq(prompt=[1, 2, 3], max_new_tokens=2)])
    teng = ServingModel.prepare(tcfg, tp, max_len=MAX_LEN, slots=2, device="cpu").engine(
        chunk=4)
    assert not teng.pool.paged
    assert [s.kind for s in teng.pool.specs] == ["paged_kv", "static"]
    with pytest.raises(ValueError, match="src_frames"):
        teng.serve([GenerationRequest(prompt=[1, 2, 3], max_new_tokens=2)])


def test_static_memory_is_copied_at_insert_and_kept_at_retire(models):
    _, tcfg, _, _ = models
    pool = tcache.CachePool(tcfg, 16, 2, device="cpu")
    staged = TM.init_decode_cache(tcfg, 1, 16, device="cpu", src_len=0)
    staged["pos"] = torch.tensor([3], dtype=torch.int32)
    req = GenerationRequest(prompt=[1, 2, 3], max_new_tokens=2)
    si = pool.alloc(req, 0)
    pool.insert(si, staged)
    pool.retire(si)
    static = next(st for st in pool.states if st.spec.kind == "static")
    assert static.spec.keys == ("cross_k", "cross_v") and not static.spec.zero_on_retire


def test_list_archs_equals_jax():
    assert list_archs() == sorted(j_list_archs())


@pytest.mark.parametrize("windowed", [False, True], ids=["lanes", "windowed"])
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", sorted(j_list_archs()))
def test_state_specs_and_policy_match_jax_for_every_arch(arch, smoke, windowed):
    jcfg = get_config(arch, smoke=smoke).replace(windowed_kv_cache=windowed)
    tcfg = t_get_config(arch, smoke=smoke).replace(windowed_kv_cache=windowed)
    js, ts = jcache.derive_state_specs(jcfg), tcache.derive_state_specs(tcfg)
    assert [(s.kind, s.keys, s.zero_on_retire) for s in ts] == \
        [(s.kind, s.keys, s.zero_on_retire) for s in js]
    assert tcache.derive_policy(ts).__dict__ == jcache.derive_policy(js).__dict__

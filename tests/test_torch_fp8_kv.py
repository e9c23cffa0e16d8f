"""An fp8 e4m3 KV cache (``kv_dtype="float8_e4m3fn"``) in the port against the
JAX package, on the CPU at smoke size.

The JAX contract is ``test_f8_kv_cache_close_to_bf16`` (tests/test_beyond_paper.py):
smoke llama3-8b, a 6-token prefill and 4 decode steps with an f8 cache, whose
greedy argmax equals the bf16 cache's. Here the same steps run in the port and
in JAX on the same numpy tokens and the same weights (``params_from_numpy``).
Both prefills attend over K/V in the compute dtype and store them in e4m3; both
decode steps read the cache widened to f32, as the Pallas bodies upcast what
they load.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import kv_mapping as tkv  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

F8 = "float8_e4m3fn"
PREFILL, STEPS, MAX_LEN = 6, 4, 16
# f32: XLA and torch sum in other orders (a few f32 ulps) and, on these inputs,
# every e4m3 rounding of K/V comes out the same on both sides. bf16 rounds
# activations at other places on the two sides, which moves some K/V values
# across an e4m3 rounding boundary (an e4m3 step is 2**-3 relative): the
# logits (|logits| < 4) then differ by up to about 0.1.
LOGIT_ATOL = {"float32": 1e-4, "bfloat16": 0.15}


def _tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(1).integers(0, vocab, (2, PREFILL + STEPS)).astype(np.int32)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def smoke(request):
    dtype = request.param
    jcfg = get_config("llama3-8b", smoke=True).replace(dtype=dtype, param_dtype=dtype)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return dtype, jcfg, jp, tp


def _port_run(tp, cfg, toks):
    """Prefill, then one decode step per remaining token of ``toks``: the
    logits of every step and the final cache."""
    logits, cache = TM.prefill(tp, torch.from_numpy(toks[:, :PREFILL]).long(), cfg,
                               max_len=MAX_LEN)
    out = [logits]
    for i in range(PREFILL, PREFILL + STEPS):
        logits, cache = TM.decode_step(tp, cache, torch.from_numpy(toks[:, i:i + 1]).long(),
                                       cfg)
        out.append(logits)
    return out, cache


def test_f8_kv_cache_matches_jax_and_keeps_the_bf16_argmax(smoke):
    dtype, jcfg, jp, tp = smoke
    j8 = jcfg.replace(kv_dtype=F8)
    t8, tcfg = ModelConfig(**dataclasses.asdict(j8)), ModelConfig(**dataclasses.asdict(jcfg))
    toks = _tokens(jcfg.vocab_size)

    jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :PREFILL])}, j8, max_len=MAX_LEN)
    jout = [jl]
    for i in range(PREFILL, PREFILL + STEPS):
        jl, jc = JM.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]), j8)
        jout.append(jl)
    tout, tc = _port_run(tp, t8, toks)
    bout, _ = _port_run(tp, tcfg, toks)

    assert jc["k"].dtype == jnp.float8_e4m3fn
    assert tc["k"].dtype == tc["v"].dtype == torch.float8_e4m3fn
    for step, (tl, jl) in enumerate(zip(tout, jout)):
        np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32), rtol=0,
                                   atol=LOGIT_ATOL[dtype], err_msg=f"step {step}")
    if dtype == "float32":   # the same e4m3 bits in every cache slot
        for key in ("k", "v"):
            np.testing.assert_array_equal(tc[key].view(torch.uint8).numpy(),
                                          np.asarray(jc[key]).view(np.uint8))
    # the JAX test's contract: the f8 cache keeps the greedy decisions of the
    # compute-dtype cache (here the port's), and JAX's own f8 decisions
    assert torch.equal(tout[-1].argmax(-1), bout[-1].argmax(-1))
    np.testing.assert_array_equal(tout[-1].argmax(-1).numpy(), np.asarray(jout[-1]).argmax(-1))


def test_f8_paged_decode_step_equals_the_contiguous_step(smoke):
    """One decode step over an f8 page pool (scrambled block table, 4-token
    pages) against the same step over the f8 contiguous lanes it was cut
    from: the same logits and the same bits written for the new token."""
    dtype, jcfg, _, tp = smoke
    cfg = ModelConfig(**dataclasses.asdict(jcfg.replace(kv_dtype=F8)))
    toks = _tokens(cfg.vocab_size)
    _, lanes = _port_run(tp, cfg, toks)
    bsz, b = 4, toks.shape[0]
    nb = MAX_LEN // bsz
    table = (torch.from_numpy(np.random.default_rng(3).permutation(b * nb)) + 1).reshape(
        b, nb).to(torch.int32)
    pages = tkv.init_paged_cache(cfg.n_layers, b * nb + 1, cfg.n_kv_heads, cfg.head_dim, bsz,
                                 torch.float8_e4m3fn, "cpu")
    for lane in range(b):
        for j in range(nb):
            kb, vb = tkv.extract_block(lanes["k"][:, lane], lanes["v"][:, lane], j, bsz)
            tkv.store_block(pages, int(table[lane, j]), kb, vb)
    pos = lanes["pos"]
    paged = {**pages, "block_table": table, "pos": pos.expand(b).clone()}
    nxt = torch.from_numpy(np.random.default_rng(4).integers(1, cfg.vocab_size, (b, 1))).long()
    want, lanes2 = TM.decode_step(tp, lanes, nxt, cfg)
    got, paged2 = TM.decode_step(tp, paged, nxt, cfg)
    assert paged2["k_pages"].dtype == torch.float8_e4m3fn
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for layer in range(cfg.n_layers):
        k_back, v_back = tkv.materialize_lanes(paged2["k_pages"][layer],
                                               paged2["v_pages"][layer], table)
        assert torch.equal(k_back.view(torch.uint8), lanes2["k"][layer].view(torch.uint8))
        assert torch.equal(v_back.view(torch.uint8), lanes2["v"][layer].view(torch.uint8))


def test_f8_audio_prefill_matches_jax():
    """seamless-m4t-large-v2 at f32 smoke with an f8 cache: the prefill's
    decoder attends over its self K/V and the encoder memory in f32 and
    stores all four in e4m3, as the JAX prefill does (the same bits). The
    JAX decode step then refuses the f8 memory (its cross-attention einsum
    has no f32 x f8 promotion), so only the prefill is compared."""
    jcfg = get_config("seamless-m4t-large-v2", smoke=True).replace(
        dtype="float32", param_dtype="float32", kv_dtype=F8)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    r = np.random.default_rng(0)
    frames = (r.standard_normal((2, 12, jcfg.d_model)) * 0.5).astype(np.float32)
    toks = r.integers(1, jcfg.vocab_size, (2, 3)).astype(np.int32)
    jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks), "src_frames": jnp.asarray(frames)},
                        jcfg, max_len=MAX_LEN)
    tl, tc = TM.prefill(tp, torch.from_numpy(toks).long(), tcfg, max_len=MAX_LEN,
                        src_frames=torch.from_numpy(frames))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_ATOL["float32"])
    for key in ("k", "v", "cross_k", "cross_v"):
        assert tc[key].dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(tc[key].view(torch.uint8).numpy(),
                                      np.asarray(jc[key]).view(np.uint8))

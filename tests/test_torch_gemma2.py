"""gemma2 in the port against the JAX package, on the CPU at an f32 smoke size.

gemma2's even layers are local: they attend to the last ``sliding_window``
tokens (8 in the smoke config), its odd layers are global; it adds attention
and final-logit softcaps, post-block norms, tied embeddings and the embedding
scale. The decode step is held against ``M.decode_step`` on the paged cache,
the contiguous cache and the ring cache (``windowed_kv_cache``: W-slot rings
for the local layers), with fills past the window so that it binds, W8A8 on
and off; ``prefill`` against ``M.prefill`` (logits and every cache leaf, ring
placement for prompts shorter and longer than W); and ``Engine.serve``
(tokens, states, events) against the JAX engine in the three modes, on the
paged pool and on the ring pool, a preempted ring request included.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.pim_modes import Mode as JMode  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.api import GenerationRequest as JReq  # noqa: E402
from repro.serve.serving_model import ServingModel as JServing  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.pim_modes import Mode  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import cache as tcache  # noqa: E402
from repro_torch.serve.api import GenerationRequest  # noqa: E402
from repro_torch.serve.serving_model import ServingModel  # noqa: E402
from repro_torch.serve.spec import SpecConfig, SpecDecoder  # noqa: E402
from test_torch_model import paged_cache, t  # noqa: E402
from test_torch_serve import REPORT_KEYS, event_fields  # noqa: E402

MODES = ["BLOCKED", "HBCEM", "LBIM"]
TOL = dict(rtol=1e-5, atol=1e-5)
# prompts past the smoke window (8) beside short ones; ragged
PROMPTS = [[(5 * i + 3 * j) % 250 + 1 for j in range(n)]
           for i, n in enumerate((13, 3, 10, 6, 17))]
BUDGETS = [5, 7, 3, 6, 4]
MAX_LEN = 32


@pytest.fixture(scope="module")
def models():
    jcfg = get_config("gemma2-27b", smoke=True).replace(dtype="float32",
                                                         param_dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jp, tp


def test_params_tree_matches_jax(models):
    """Tied embeddings (no ``lm_head``) and the post-block norms, in the
    carried-over tree and in the port's own init."""
    jcfg, tcfg, jp, tp = models
    assert "lm_head" not in tp and "lm_head" not in jp
    fresh = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(fresh) == set(tp)
    assert set(fresh["layers"][0]) == set(tp["layers"][0]) >= {"post_attn_norm",
                                                                "post_mlp_norm"}
    assert TM.layer_windows(tcfg) == [8, TM.GLOBAL_WINDOW]


def test_embedding_scale_rounds_to_activation_dtype():
    """gemma2-27b's sqrt(4608) is rounded to bf16 (68.0) before the product."""
    cfg = get_config("gemma2-27b")
    p = {"embed": {"w": torch.ones((2, 4), dtype=torch.bfloat16)}}
    x = TM._embed(p, torch.zeros((1, 1), dtype=torch.long), ModelConfig(
        **dataclasses.asdict(cfg)))
    assert x.dtype == torch.bfloat16 and float(x[0, 0, 0]) == 68.0
    want = jnp.ones((4,), jnp.bfloat16) * jnp.asarray(cfg.d_model ** 0.5, jnp.bfloat16)
    assert float(want[0]) == 68.0


def _check_step(jcfg, tcfg, jp, tp, jc, tokens):
    """One step from the same cache on both sides: logits, greedy tokens and
    every cache leaf (written in place) within f32 tolerance."""
    tc = {k: t(v) for k, v in jc.items()}
    leaves = {k: v for k, v in tc.items() if k not in ("pos", "block_table")}
    jlog, jc2 = JM.decode_step(jp, {k: jnp.asarray(v) for k, v in jc.items()},
                               jnp.asarray(tokens), jcfg)
    tlog, tc2 = TM.decode_step(tp, tc, t(tokens).long(), tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert (tlog.argmax(-1).numpy() == np.asarray(jlog).argmax(-1)).all()
    assert tc2["pos"].tolist() == (np.asarray(jc["pos"]) + tokens.shape[1]).tolist()
    for k, leaf in leaves.items():
        assert tc2[k] is leaf                          # in place, never copied
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jc2[k]), **TOL)
    return {k: np.asarray(v) for k, v in jc2.items()}


@pytest.mark.parametrize("tok", [1, 4])
@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_step_vs_jax(models, tok, quantized):
    """Fills 0, 9 and 17 over 24-token lanes: the local layer's window (8)
    binds in two lanes, the global layer reads everything."""
    jcfg, tcfg, jp, tp = models
    jcfg, tcfg = (c.replace(quantized_decode=quantized) for c in (jcfg, tcfg))
    c = paged_cache(jcfg, b=3, nb=6, bsz=4, pos=[0, 9, 17], seed=tok)
    tokens = np.random.default_rng(11).integers(1, jcfg.vocab_size, (3, tok)).astype(np.int32)
    _check_step(jcfg, tcfg, jp, tp, c, tokens)


def _contiguous_cache(cfg, b, lmax, pos, seed):
    r = np.random.default_rng(seed)
    c = {k: (r.standard_normal(v.shape) * 0.5).astype(np.float32)
         for k, v in JM.init_decode_cache(cfg, b, lmax).items() if k != "pos"}
    c["pos"] = np.asarray(pos, np.int32)
    return c


@pytest.mark.parametrize("tok", [1, 4])
@pytest.mark.parametrize("quantized", [False, True])
def test_contiguous_decode_step_vs_jax(models, tok, quantized):
    jcfg, tcfg, jp, tp = models
    jcfg, tcfg = (c.replace(quantized_decode=quantized) for c in (jcfg, tcfg))
    c = _contiguous_cache(jcfg, 3, 24, [0, 9, 17], seed=tok)
    tokens = np.random.default_rng(12).integers(1, jcfg.vocab_size, (3, tok)).astype(np.int32)
    _check_step(jcfg, tcfg, jp, tp, c, tokens)


@pytest.mark.parametrize("quantized", [False, True])
def test_ring_decode_steps_vs_jax(models, quantized):
    """Three single-token steps over 8-slot rings and 24-token global lanes,
    lanes at 0, 6 and 13: one fills its ring past W in these steps, one has
    wrapped. Each step starts both sides from the JAX cache of the step
    before (under W8A8 an f32 ulp can flip one activation's int8 rounding)."""
    jcfg, tcfg, jp, tp = models
    jcfg, tcfg = (c.replace(quantized_decode=quantized, windowed_kv_cache=True)
                  for c in (jcfg, tcfg))
    c = _contiguous_cache(jcfg, 3, 24, [0, 6, 13], seed=5)
    assert c["k_loc"].shape[-1] == jcfg.sliding_window
    r = np.random.default_rng(13)
    for _ in range(3):
        c = _check_step(jcfg, tcfg, jp, tp, c,
                        r.integers(1, jcfg.vocab_size, (3, 1)).astype(np.int32))


def test_global_window_equals_no_window(models):
    """A global layer's window of 2^30 gives start 0: the same bits as no
    window at all, paged and contiguous."""
    jcfg, tcfg, _, tp = models
    lp = tp["layers"][1]["attn"]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((3, 1, 64)).astype(
        np.float32))
    pc = {k: t(v) for k, v in paged_cache(jcfg, b=3, nb=6, bsz=4, pos=[0, 9, 17],
                                          seed=2).items()}
    cc = {k: t(v) for k, v in _contiguous_cache(jcfg, 3, 24, [0, 9, 17], seed=2).items()}
    outs = []
    for window in (None, TM.GLOBAL_WINDOW):
        p = {k: v.clone() for k, v in pc.items()}
        c = {k: v.clone() for k, v in cc.items()}
        outs.append((TA.attention_decode_paged(lp, x, p["k_pages"][1], p["v_pages"][1],
                                               p["block_table"], p["pos"], tcfg,
                                               window=window),
                     TA.attention_decode(lp, x, c["k"][1], c["v"][1], c["pos"], tcfg,
                                         window=window)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("split", [6, 12])   # prompt < W and prompt > W (W = 8)
def test_prefill_vs_jax(models, split):
    """``prefill`` against ``M.prefill``, with and without the ring cache:
    logits and every cache leaf, ``k_loc``/``v_loc`` at their ring slots
    included; then decode steps from both caches agree (the mirror of the
    JAX package's ``test_ring_kv_cache_matches_full``)."""
    jcfg, tcfg, jp, tp = models
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 14), 0,
                                         jcfg.vocab_size), np.int32)
    caches = {}
    for ring in (False, True):
        jc_ = jcfg.replace(windowed_kv_cache=ring)
        tc_ = tcfg.replace(windowed_kv_cache=ring)
        jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :split])}, jc_, max_len=32)
        tl, tc = TM.prefill(tp, t(toks[:, :split]).long(), tc_, max_len=32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert set(tc) == set(jc) and int(tc["pos"]) == split
        for k in jc:
            assert tuple(tc[k].shape) == jc[k].shape, k
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)
        caches[ring] = (tc_, tc)
    assert caches[True][1]["k_loc"].shape[-1] == tcfg.sliding_window
    (fcfg, full), (rcfg, ring) = caches[False], caches[True]
    for i in range(split, 14):
        lf, full = TM.decode_step(tp, full, t(toks[:, i:i + 1]).long(), fcfg)
        lr, ring = TM.decode_step(tp, ring, t(toks[:, i:i + 1]).long(), rcfg)
        np.testing.assert_allclose(lr.numpy(), lf.numpy(), rtol=1e-4, atol=1e-4)


def test_prefill_ragged_rows_vs_jax(models):
    """A right-padded batch with ``seq_lens``: each row's logits at its own
    last token."""
    jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(4).integers(1, jcfg.vocab_size, (3, 11)).astype(np.int32)
    lens = np.asarray([11, 4, 9], np.int32)
    jl, _ = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 32, seq_lens=lens)
    tl, _ = TM.prefill(tp, t(toks).long(), tcfg, 32, seq_lens=t(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


# --------------------------------------------------------------------------
# Engine.serve
# --------------------------------------------------------------------------


def result_fields(r):
    return (r.tokens, r.finish_reason, r.state.value, r.prompt_len, r.preemptions,
            r.reused_prefix_tokens, r.admit_step, r.first_token_step, r.finish_step)


def _requests(cls, prompts, budgets, prio=None, arrival=None):
    prio = prio or [0] * len(prompts)
    arrival = arrival or [0] * len(prompts)
    return [cls(prompt=p, max_new_tokens=b, priority=q, arrival_step=a)
            for p, b, q, a in zip(prompts, budgets, prio, arrival)]


def run_jax(jcfg, jp, mode, ring, **kw):
    cfg = jcfg.replace(windowed_kv_cache=ring)
    eng = JServing.prepare(cfg, jp, max_len=MAX_LEN, slots=2).engine(mode=JMode[mode],
                                                                      chunk=4)
    assert eng.pool.paged != ring and eng.pool.policy.chunkable != ring
    res = eng.serve(_requests(JReq, **kw))
    rep = eng.schedule_report()
    return ([result_fields(r) for r in res], [event_fields(e) for e in eng.events],
            {k: rep[k] for k in REPORT_KEYS})


def run_torch(tcfg, tp, mode, ring, **kw):
    cfg = tcfg.replace(windowed_kv_cache=ring)
    eng = ServingModel.prepare(cfg, tp, max_len=MAX_LEN, slots=2, device="cpu").engine(
        mode=Mode[mode], chunk=4)
    assert eng.pool.paged != ring and eng.pool.policy.chunkable != ring
    res = eng.serve(_requests(GenerationRequest, **kw))
    assert eng.pool.check_invariants() == []
    rep = eng.schedule_report()
    return ([result_fields(r) for r in res], [event_fields(e) for e in eng.events],
            {k: rep[k] for k in REPORT_KEYS})


@pytest.mark.parametrize("ring", [False, True], ids=["paged", "ring"])
@pytest.mark.parametrize("mode", MODES)
def test_engine_serve_matches_jax(models, mode, ring):
    """Five ragged requests over two lanes: batch admission, then staged
    admission (chunked on the paged pool, one solo prefill per request on
    the ring pool) while lanes decode."""
    jcfg, tcfg, jp, tp = models
    kw = dict(prompts=PROMPTS, budgets=BUDGETS)
    jres, jev, jrep = run_jax(jcfg, jp, mode, ring, **kw)
    tres, tev, trep = run_torch(tcfg, tp, mode, ring, **kw)
    assert (tres, tev, trep) == (jres, jev, jrep)
    assert all(r[2] == "finished" for r in tres)


def test_ring_preemption_resumes_like_jax(models):
    """A priority-1 request arriving while both lanes decode preempts the
    lowest-priority lane; the victim re-prefills prompt + emitted tokens in
    one solo prefill and resumes; tokens, states and events equal the JAX
    engine's, and the victim's tokens equal an unpreempted serve's."""
    jcfg, tcfg, jp, tp = models
    kw = dict(prompts=[PROMPTS[0], PROMPTS[2], PROMPTS[4]], budgets=[9, 8, 3],
              prio=[0, 0, 1], arrival=[0, 0, 3])
    jres, jev, jrep = run_jax(jcfg, jp, "HBCEM", True, **kw)
    tres, tev, trep = run_torch(tcfg, tp, "HBCEM", True, **kw)
    assert (tres, tev, trep) == (jres, jev, jrep)
    assert sum(r[4] for r in tres) >= 1 and all(r[2] == "finished" for r in tres)
    victim = next(i for i, r in enumerate(tres) if r[4])
    alone, _, _ = run_torch(tcfg, tp, "HBCEM", True, prompts=[kw["prompts"][victim]],
                            budgets=[kw["budgets"][victim]])
    assert alone[0][0] == tres[victim][0]


def test_ring_pool_specs_and_policy_match_jax(models):
    from repro.serve import cache as jcache

    jcfg, tcfg, _, _ = models
    for ring in (False, True):
        js = jcache.derive_state_specs(jcfg.replace(windowed_kv_cache=ring))
        ts = tcache.derive_state_specs(tcfg.replace(windowed_kv_cache=ring))
        assert [(s.kind, s.keys, s.zero_on_retire) for s in ts] == \
            [(s.kind, s.keys, s.zero_on_retire) for s in js]
        assert tcache.derive_policy(ts) .__dict__ == jcache.derive_policy(js).__dict__


def test_spec_refuses_a_ring_draft(models):
    _, tcfg, _, tp = models
    target = ServingModel.prepare(tcfg, tp, max_len=MAX_LEN, slots=2, device="cpu")
    draft = ServingModel.prepare(tcfg.replace(windowed_kv_cache=True), tp, max_len=MAX_LEN,
                                 slots=2, device="cpu")
    with pytest.raises(ValueError, match="ring"):
        SpecDecoder(draft, target, slots=2, max_len=MAX_LEN, k=2)
    with pytest.raises(ValueError, match="ring"):
        target.engine(spec=SpecConfig(draft=draft, k=2))

"""The port's rwkv6 (RWKV6 "Finch", ``family="ssm"``) against the JAX package,
on the CPU at an f32 smoke size.

The config copy and the weight tree (its 3-D ``mix_w2`` and ``(5, d)``
``mix_base`` leaves); ``layernorm``, ``token_shift``, ``_ddlerp``, the WKV
recurrence and one block from random states; ``prefill`` and per-step
``decode_step`` (the stacked state written in place); then ``Engine.serve``
in BLOCKED, HBCEM and LBIM (tokens, request states, ``ScheduleEvent``
streams), with a ragged wave, a sampled request and a priority preemption
whose victim resumes from zeroed state; and rwkv6 drafting for a llama3-8b
target (the JAX spec suite's cross-family pair, vocab 256 at smoke size).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.pim_modes import Mode as JMode  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro.serve import cache as jcache  # noqa: E402
from repro.serve.api import GenerationRequest as JReq  # noqa: E402
from repro.serve.api import SamplingParams as JSP  # noqa: E402
from repro.serve.serving_model import ServingModel as JServing  # noqa: E402
from repro.serve.spec import SpecConfig as JSpec  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.core.pim_modes import Mode  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import rwkv as TR  # noqa: E402
from repro_torch.serve import cache as tcache  # noqa: E402
from repro_torch.serve.api import GenerationRequest, RequestState, SamplingParams  # noqa: E402
from repro_torch.serve.serving_model import ServingModel  # noqa: E402
from repro_torch.serve.spec import SpecConfig  # noqa: E402
from serving_refs import BUDGETS, MAX_LEN, PROMPTS  # noqa: E402
from test_torch_serve import REPORT_KEYS, event_fields  # noqa: E402

MODES = ["BLOCKED", "HBCEM", "LBIM"]
F32 = dict(dtype="float32", param_dtype="float32")
TOL = dict(rtol=1e-5, atol=1e-5)
STATE = ("wkv", "att_tail", "ffn_tail")


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    jcfg = get_config("rwkv6-1.6b", smoke=True).replace(**F32)
    # jit: the eager init of the stacked tree takes seconds of dispatch
    jp = jax.jit(functools.partial(JM.init_params, cfg=jcfg))(jax.random.PRNGKey(1))
    # u (the bonus) and w0 start constant: draw them, so the tests see them
    r = np.random.default_rng(5)
    blk = dict(jp["layers"]["block"])
    blk["u"] = jnp.asarray((r.standard_normal(blk["u"].shape) * 0.5).astype(np.float32))
    blk["w0"] = jnp.asarray((r.standard_normal(blk["w0"].shape) - 2.0).astype(np.float32))
    jp = {**jp, "layers": {**jp["layers"], "block": blk}}
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    yield jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jp, tp
    jax.clear_caches()


def _layer(jp, i=0):
    return jax.tree_util.tree_map(lambda a: a[i], jp["layers"])


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_copy_matches_jax(smoke):
    assert dataclasses.asdict(t_get_config("rwkv6-1.6b", smoke=smoke)) == \
        dataclasses.asdict(get_config("rwkv6-1.6b", smoke=smoke))
    full = t_get_config("rwkv6-1.6b")
    assert (full.family, full.n_layers, full.d_model, full.d_ff, full.vocab_size) == \
        ("ssm", 24, 2048, 7168, 65536)
    assert TR.rwkv_dims(full) == (2048, 32, 64)


def test_params_tree_matches_jax(models):
    """Every stacked leaf splits per layer bit for bit, the 3-D ``mix_w2`` and
    the (5, d) ``mix_base`` included; a fresh torch init has JAX's tree."""
    jcfg, tcfg, jp, tp = models
    assert len(tp["layers"]) == jcfg.n_layers
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [k.key for k in path]
        arr = np.asarray(leaf)
        nodes = ([(tp["layers"][i], arr[i]) for i in range(jcfg.n_layers)]
                 if keys[0] == "layers" else [(tp, arr)])
        for node, want in nodes:
            for k in keys[1 if keys[0] == "layers" else 0:]:
                node = node[k]
            np.testing.assert_array_equal(node.numpy(), want)
    blk = tp["layers"][0]["block"]
    assert blk["mix_w2"].shape == (5, TR.LORA_MIX, jcfg.d_model)
    assert blk["mix_base"].shape == (5, jcfg.d_model)
    fresh = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(fresh) == set(tp) == {"embed", "layers", "ln_in", "final_norm", "lm_head"}
    for name, leaf in tp["layers"][0]["block"].items():
        got = fresh["layers"][0]["block"][name]
        if isinstance(leaf, dict):
            assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in leaf.items()}
        else:
            assert (got.shape, got.dtype) == (leaf.shape, leaf.dtype), name


def test_layernorm_and_token_shift_vs_jax():
    r = np.random.default_rng(0)
    x = (r.standard_normal((2, 5, 48)) * 3 + 1).astype(np.float32)
    p = {"scale": r.standard_normal(48).astype(np.float32),
         "bias": r.standard_normal(48).astype(np.float32)}
    got = TL.layernorm({k: t(v) for k, v in p.items()}, t(x), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(JL.layernorm(p, jnp.asarray(x))), **TOL)
    np.testing.assert_array_equal(TL.token_shift(t(x)).numpy(),
                                  np.asarray(JL.token_shift(jnp.asarray(x))))
    assert TL.init_layernorm(8, torch.float32, "cpu")["bias"].abs().sum() == 0


def test_ddlerp_vs_jax(models):
    _, _, jp, tp = models
    r = np.random.default_rng(1)
    d = tp["layers"][0]["block"]["wr"].shape[0]
    x, xp = (r.standard_normal((2, 6, d)).astype(np.float32) for _ in range(2))
    jb = _layer(jp)["block"]
    want = JR._ddlerp(jb, jnp.asarray(x), jnp.asarray(xp))
    got = TR._ddlerp(tp["layers"][0]["block"], t(x), t(xp))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("steps", [1, 7, 64])
def test_wkv_scan_vs_jax(steps):
    """The recurrence from a random state: y reads the state before each
    step's update, and the state stays key-major."""
    r = np.random.default_rng(steps)
    b, h, hd = 2, 2, 64
    r_, k, v = (r.standard_normal((b, steps, h, hd)).astype(np.float32) * 0.5
                for _ in range(3))
    w = np.exp(-np.exp(r.standard_normal((b, steps, h, hd)) - 1)).astype(np.float32)
    u = r.standard_normal((h, hd)).astype(np.float32)
    s0 = r.standard_normal((b, h, hd, hd)).astype(np.float32)
    jy, js = JR._wkv_scan(*(jnp.asarray(a) for a in (r_, k, v, w, u, s0)))
    s0_t = t(s0)
    ty, ts = TR._wkv_scan(t(r_), t(k), t(v), t(w), t(u), s0_t)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_array_equal(s0_t.numpy(), s0)        # the input state is not written


def _random_state(jcfg, b, seed):
    r = np.random.default_rng(seed)
    st = JR.init_rwkv_state(b, jcfg)
    return {k: (r.standard_normal(v.shape) * 0.3).astype(np.float32) for k, v in st.items()}


def test_rwkv_block_vs_jax(models):
    jcfg, tcfg, jp, tp = models
    st = _random_state(jcfg, 2, 3)
    x = np.random.default_rng(4).standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    jl = _layer(jp, 1)
    jy, jst = JR.rwkv_block(jl["block"], jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                                          st.items()},
                            jcfg, jl["ln1"], jl["ln2"], jcfg.norm_eps)
    tl = tp["layers"][1]
    ty, tst = TR.rwkv_block(tl["block"], t(x), {k: t(v) for k, v in st.items()}, tcfg,
                            tl["ln1"], tl["ln2"], tcfg.norm_eps)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for k in STATE:
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), **TOL)


def test_decode_cache_matches_jax(models):
    jcfg, tcfg, _, _ = models
    jc = JM.init_decode_cache(jcfg, 3, 16)
    specs = TM.decode_cache_specs(tcfg, 3, 16)
    assert set(specs) == set(jc) == {*STATE, "pos"}
    for key, (shape, _) in specs.items():
        assert shape == jc[key].shape, key
    assert specs["wkv"][1] == torch.float32


def test_prefill_vs_jax(models):
    """Ragged rows: logits at each row's last true token; the state covers
    the padded row, pads included, as in the JAX package."""
    jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(6).integers(1, jcfg.vocab_size, (2, 11)).astype(np.int32)
    jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 24,
                        seq_lens=jnp.asarray([11, 6]))
    tl, tc = TM.prefill(tp, t(toks).long(), tcfg, 24, seq_lens=torch.tensor([11, 6]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == 11
    for k in STATE:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)


def test_decode_steps_vs_jax(models):
    """Steps of 1, 4 and 1 tokens from a random shared state, each step
    starting both sides from the JAX state of the step before: logits,
    greedy tokens and every state leaf, written in place."""
    jcfg, tcfg, jp, tp = models
    b = 3
    jc = {k: jnp.asarray(np.stack([v] * jcfg.n_layers)) for k, v in
          _random_state(jcfg, b, 8).items()}
    jc["pos"] = jnp.asarray([0, 5, 9], jnp.int32)
    r = np.random.default_rng(9)
    for tok in (1, 4, 1):
        tokens = r.integers(1, jcfg.vocab_size, (b, tok)).astype(np.int32)
        tc = {k: t(v) for k, v in jc.items()}
        leaves = {k: tc[k] for k in STATE}
        pos = np.asarray(jc["pos"])
        jlog, jc = JM.decode_step(jp, jc, jnp.asarray(tokens), jcfg)
        tlog, tc = TM.decode_step(tp, tc, t(tokens).long(), tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-5)
        assert (tlog.argmax(-1).numpy() == np.asarray(jlog).argmax(-1)).all()
        assert tc["pos"].tolist() == (pos + tok).tolist()
        for k, leaf in leaves.items():
            assert tc[k] is leaf                          # in place, never copied
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jc[k]), **TOL)


def test_pool_is_recurrent_only_and_zeroes_on_retire(models):
    """No KV, not pageable (a paged ask falls back), the JAX specs and
    policy, and a retired lane's state zeroed before its reuse."""
    jcfg, tcfg, _, _ = models
    ts, js = tcache.derive_state_specs(tcfg), jcache.derive_state_specs(jcfg)
    assert [(s.kind, s.keys, s.zero_on_retire) for s in ts] == \
        [(s.kind, s.keys, s.zero_on_retire) for s in js] == \
        [("recurrent", tuple(sorted(STATE)), True)]
    assert tcache.derive_policy(ts).__dict__ == jcache.derive_policy(js).__dict__
    pool = tcache.CachePool(tcfg, 16, 2, paged=True, device="cpu")
    assert not pool.paged and not pool.prefix_cache and pool.table_blocks == 0
    req = GenerationRequest(prompt=[1, 2, 3], max_new_tokens=2)
    staged, skip = pool.stage_admission(req.prompt)
    assert skip == 0 and set(staged) == {*STATE, "pos"}
    for k in STATE:
        staged[k].fill_(1.0)
    staged["pos"] = torch.tensor([3], dtype=torch.int32)
    si = pool.alloc(req, 0)
    pool.insert(si, staged)
    assert all(bool((pool.views()[k][:, si] == 1).all()) for k in STATE)
    pool.retire(si)
    view = pool.views()
    assert not any(view[k][:, si].any() for k in STATE) and view["pos"][si] == 0
    assert pool.check_invariants() == []


# --------------------------------------------------------------------------
# Engine.serve
# --------------------------------------------------------------------------


def result_fields(r):
    return (r.tokens, r.finish_reason, r.state.value, r.prompt_len, r.preemptions,
            r.admit_step, r.first_token_step, r.finish_step)


def _reqs(cls, sp_cls, prompts, budgets, samplers=None, prio=None, arrival=None):
    n = len(prompts)
    samplers, prio, arrival = samplers or [{}] * n, prio or [0] * n, arrival or [0] * n
    return [cls(prompt=list(p), max_new_tokens=b, sampling=sp_cls(**s), priority=q,
                arrival_step=a)
            for p, b, s, q, a in zip(prompts, budgets, samplers, prio, arrival)]


def run_jax(jcfg, jp, mode, slots=2, chunk=4, **kw):
    eng = JServing.prepare(jcfg, jp, max_len=MAX_LEN, slots=slots).engine(
        mode=JMode[mode], chunk=chunk)
    assert not eng.pool.paged
    res = eng.serve(_reqs(JReq, JSP, **kw))
    rep = eng.schedule_report()
    return ([result_fields(r) for r in res], [event_fields(e) for e in eng.events],
            {k: rep[k] for k in REPORT_KEYS})


def run_torch(tcfg, tp, mode, slots=2, chunk=4, **kw):
    eng = ServingModel.prepare(tcfg, tp, max_len=MAX_LEN, slots=slots, device="cpu").engine(
        mode=Mode[mode], chunk=chunk)
    assert not eng.pool.paged and not eng.pool.prefix_cache
    res = eng.serve(_reqs(GenerationRequest, SamplingParams, **kw))
    assert eng.pool.check_invariants() == []
    rep = eng.schedule_report()
    return ([result_fields(r) for r in res], [event_fields(e) for e in eng.events],
            {k: rep[k] for k in REPORT_KEYS})


@pytest.mark.parametrize("mode", MODES)
def test_engine_serve_matches_jax(models, mode):
    """Five ragged requests over two lanes, the third one sampled: batch
    admission one request per group (ragged lengths), then chunked admission
    while lanes decode."""
    jcfg, tcfg, jp, tp = models
    kw = dict(prompts=PROMPTS, budgets=BUDGETS,
              samplers=[{}, {}, dict(temperature=0.9, top_k=16, seed=3), {}, {}])
    jres, jev, jrep = run_jax(jcfg, jp, mode, **kw)
    tres, tev, trep = run_torch(tcfg, tp, mode, **kw)
    assert (tres, tev, trep) == (jres, jev, jrep)
    assert all(r[2] == "finished" for r in tres)


def test_ragged_wave_matches_jax_and_single_sequences(models):
    """The JAX system suite's state-family case: a ragged wave in LBIM
    (chunk 2) equals the JAX engine's and each prompt served alone."""
    jcfg, tcfg, jp, tp = models
    kw = dict(prompts=[[1, 2, 3], [1, 2], [4, 4, 4, 4]], budgets=[2, 2, 2])
    jres, jev, _ = run_jax(jcfg, jp, "LBIM", chunk=2, **kw)
    tres, tev, _ = run_torch(tcfg, tp, "LBIM", chunk=2, **kw)
    assert (tres, tev) == (jres, jev)
    for i, p in enumerate(kw["prompts"]):
        alone, _, _ = run_torch(tcfg, tp, "HBCEM", slots=1, prompts=[p], budgets=[2])
        assert alone[0][0] == tres[i][0]


def test_equal_length_batch_admission_matches_jax(models):
    """Equal lengths ride one group: the JAX engine's one batched prefill,
    the port's staged sub-steps; tokens and the single admission event
    agree."""
    jcfg, tcfg, jp, tp = models
    kw = dict(prompts=[[5, 6, 7, 8, 9, 10], [11, 3, 8, 2, 2, 1]], budgets=[4, 3])
    jres, jev, _ = run_jax(jcfg, jp, "HBCEM", **kw)
    tres, tev, _ = run_torch(tcfg, tp, "HBCEM", **kw)
    assert (tres, tev) == (jres, jev)
    assert tev[0][5] == 12 and not tev[0][1]          # one event admits both


def test_preemption_resumes_from_zeroed_state_like_jax(models):
    """A priority-1 arrival preempts the lowest-priority lane: its recurrent
    state is zeroed with the lane, the victim re-prefills prompt + emitted
    tokens and resumes; tokens, states and events equal the JAX engine's,
    and the victim's tokens equal an unpreempted serve's."""
    jcfg, tcfg, jp, tp = models
    kw = dict(prompts=[PROMPTS[1], PROMPTS[2], PROMPTS[4]], budgets=[9, 8, 3],
              prio=[0, 0, 1], arrival=[0, 0, 3])
    jres, jev, jrep = run_jax(jcfg, jp, "HBCEM", **kw)
    retired = []
    orig = tcache.CachePool.retire

    def spy(pool, slot):
        orig(pool, slot)
        retired.append(all(not pool.views()[k][:, slot].any() for k in STATE))

    tcache.CachePool.retire = spy
    try:
        tres, tev, trep = run_torch(tcfg, tp, "HBCEM", **kw)
    finally:
        tcache.CachePool.retire = orig
    assert (tres, tev, trep) == (jres, jev, jrep)
    assert sum(r[4] for r in tres) >= 1 and all(r[2] == "finished" for r in tres)
    assert retired and all(retired)
    victim = next(i for i, r in enumerate(tres) if r[4])
    alone, _, _ = run_torch(tcfg, tp, "HBCEM", prompts=[kw["prompts"][victim]],
                            budgets=[kw["budgets"][victim]])
    assert alone[0][0] == tres[victim][0]


# --------------------------------------------------------------------------
# rwkv6 drafting for a llama3-8b target
# --------------------------------------------------------------------------


def _spec_events(eng):
    return [(e.plan.label, e.decode_batch, e.prefill_tokens, e.decode_ctx, e.reused_tokens,
             e.emitted_tokens, e.first_tokens, e.spec_drafted, e.spec_accepted,
             e.spec_draft_steps, e.verify_tokens, e.spec_max_emitted,
             e.draft_prefill_tokens)
            for e in eng.events]


@pytest.mark.parametrize("mode", ["HBCEM", "LBIM"])
def test_rwkv6_draft_for_llama_target_matches_jax(models, mode):
    """The JAX spec suite's cross-family pair: a recurrent draft that cannot
    truncate its state drafts through the anchor/catch-up protocol. Tokens
    equal the plain engine's, and tokens, events and the spec report equal
    the JAX spec engine's."""
    jdcfg, tdcfg, jdp, tdp = models
    jcfg = get_config("llama3-8b", smoke=True).replace(**F32)
    assert jcfg.vocab_size == jdcfg.vocab_size
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tt = ServingModel.prepare(ModelConfig(**dataclasses.asdict(jcfg)), tp, max_len=MAX_LEN,
                              slots=2, device="cpu")
    td = ServingModel.prepare(tdcfg, tdp, max_len=MAX_LEN, slots=2, device="cpu")
    jt = JServing.prepare(jcfg, jp, max_len=MAX_LEN, slots=2)
    jd = JServing.prepare(jdcfg, jdp, max_len=MAX_LEN, slots=2)
    kw = dict(prompts=PROMPTS, budgets=BUDGETS)
    plain = tt.engine(mode=Mode[mode], chunk=4).serve(_reqs(GenerationRequest,
                                                            SamplingParams, **kw))
    teng = tt.engine(mode=Mode[mode], chunk=4, spec=SpecConfig(draft=td, k=3))
    tres = teng.serve(_reqs(GenerationRequest, SamplingParams, **kw))
    jeng = jt.engine(mode=JMode[mode], chunk=4, spec=JSpec(draft=jd, k=3))
    jres = jeng.serve(_reqs(JReq, JSP, **kw))
    assert [r.tokens for r in tres] == [r.tokens for r in plain] == [r.tokens for r in jres]
    assert all(r.state is RequestState.FINISHED for r in tres)
    rep = teng.schedule_report()["spec"]
    assert rep == jeng.schedule_report()["spec"]
    assert rep["proposed"] > 0 and rep["draft_steps"] > 0
    assert _spec_events(teng) == _spec_events(jeng)
    for pool in (teng.pool, teng.spec_dec.pool):
        assert pool.check_invariants() == [] and pool.occupancy().slots_used == 0
    assert not teng.spec_dec.pool.paged

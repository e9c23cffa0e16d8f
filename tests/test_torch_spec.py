"""The port's speculative decoding against its own non-spec engine and the JAX
package's spec engine, on the CPU (llama3-8b smoke, f32).

The contract is the reference's: a spec engine's tokens equal the non-spec
engine's at every temperature (greedy, sampled, W8A8 target; BLOCKED/HBCEM/
LBIM; prefix reuse on and off), and the draft only changes the cost. Here the
port's spec tokens, events and ``schedule_report()["spec"]`` must also equal
the JAX spec engine's with the same draft, and the port's pimsim must price
the port's spec events as the JAX pimsim prices the JAX spec engine's, with a
real draft spec and self-drafted (A.5); both pools must pass
``check_invariants()`` and end empty. Then the copy-on-write fork protocol of
the paged pool, which the port's in-place page writes make load-bearing.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.pim_modes import Mode as JMode  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.api import GenerationRequest as JReq  # noqa: E402
from repro.serve.api import SamplingParams as JSP  # noqa: E402
from repro.serve.serving_model import ServingModel as JServing  # noqa: E402
from repro.serve.spec import SpecConfig as JSpec  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.pim_modes import Mode  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.api import GenerationRequest, RequestState, SamplingParams  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.errors import EngineStateError  # noqa: E402
from repro_torch.serve.serving_model import ServingModel  # noqa: E402
from repro_torch.serve.spec import SpecConfig, SpecDecoder  # noqa: E402
from serving_refs import BUDGETS, MAX_LEN, PROMPTS  # noqa: E402

MODES = ["BLOCKED", "HBCEM", "LBIM"]
F32 = dict(dtype="float32", param_dtype="float32")
K = 3
# the sampled set of the reference's spec suite: a greedy rider among sampled lanes
SAMPLERS = [dict(temperature=0.8, seed=1), dict(temperature=1.1, top_k=8, seed=2), dict(),
            dict(temperature=0.9, top_p=0.7, seed=3),
            dict(temperature=0.7, top_k=16, top_p=0.9, seed=4)]


def _to_torch(jcfg, jp):
    return (ModelConfig(**dataclasses.asdict(jcfg)),
            TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu"))


@pytest.fixture(scope="module")
def models():
    """llama3-8b smoke (the target; W8A8 off and on) and zamba2-7b smoke (a
    cross-family draft with recurrent state, vocab 256 as llama's), f32, as
    (JAX artifact, port artifact) pairs."""
    jcfg = get_config("llama3-8b", smoke=True).replace(**F32)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    zcfg = get_config("zamba2-7b", smoke=True).replace(**F32)
    zp = JM.init_params(jax.random.PRNGKey(1), zcfg)
    assert zcfg.vocab_size == jcfg.vocab_size
    out = {}
    for name, cfg, params in (("llama", jcfg, jp), ("llama_w8a8",
                                                    jcfg.replace(quantized_decode=True), jp),
                              ("zamba2", zcfg, zp)):
        tcfg, tp = _to_torch(cfg, params)
        out[name] = (JServing.prepare(cfg, params, max_len=MAX_LEN, slots=2),
                     ServingModel.prepare(tcfg, tp, max_len=MAX_LEN, slots=2, device="cpu"))
    yield out
    jax.clear_caches()


def _jreqs(samplers=None, prompts=PROMPTS, budgets=BUDGETS):
    samplers = samplers or [{}] * len(prompts)
    return [JReq(prompt=list(p), max_new_tokens=b, sampling=JSP(**s))
            for p, b, s in zip(prompts, budgets, samplers)]


def _treqs(samplers=None, prompts=PROMPTS, budgets=BUDGETS, **kw):
    samplers = samplers or [{}] * len(prompts)
    return [GenerationRequest(prompt=list(p), max_new_tokens=b,
                              sampling=SamplingParams(**s), **kw)
            for p, b, s in zip(prompts, budgets, samplers)]


def _events(eng):
    return [(e.plan.label, e.decode_batch, e.prefill_tokens, e.decode_ctx, e.reused_tokens,
             e.kv_splits, e.emitted_tokens, e.first_tokens, e.spec_drafted, e.spec_accepted,
             e.spec_draft_steps, e.verify_tokens, e.spec_max_emitted, e.draft_prefill_tokens)
            for e in eng.events]


def _no_leaks(eng):
    assert eng.pool.check_invariants() == []
    assert eng.pool.occupancy().slots_used == 0
    assert eng.spec_dec.pool.check_invariants() == []
    assert eng.spec_dec.pool.occupancy().slots_used == 0


def _serve_both(models, target, draft, mode, samplers=None, prefix=True):
    """Port: plain and spec; JAX: spec. Returns the three token lists, both
    spec engines."""
    jt, tt = models[target]
    jd, td = models[draft]
    plain = tt.engine(mode=Mode[mode], chunk=4, prefix_cache=prefix).serve(_treqs(samplers))
    teng = tt.engine(mode=Mode[mode], chunk=4, prefix_cache=prefix,
                     spec=SpecConfig(draft=td, k=K))
    tres = teng.serve(_treqs(samplers))
    jeng = jt.engine(mode=JMode[mode], chunk=4, prefix_cache=prefix,
                     spec=JSpec(draft=jd, k=K))
    jres = jeng.serve(_jreqs(samplers))
    assert all(r.state is RequestState.FINISHED for r in tres)
    _no_leaks(teng)
    return ([r.tokens for r in plain], [r.tokens for r in tres], [r.tokens for r in jres],
            teng, jeng)


@pytest.mark.parametrize("prefix", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_spec_greedy_equals_plain_and_jax(models, mode, prefix):
    plain, spec, jspec, teng, jeng = _serve_both(models, "llama", "llama", mode,
                                                 prefix=prefix)
    assert spec == plain == jspec
    rep = teng.schedule_report()["spec"]
    assert rep == jeng.schedule_report()["spec"]
    assert rep["enabled"] and rep["rounds"] >= 1 and rep["accepted"] > 0
    assert _events(teng) == _events(jeng)
    _spec_priced_as_jax(teng, jeng)


def _spec_priced_as_jax(teng, jeng):
    """A.5's pricing contract: the port's pimsim over the port's spec events
    equals the JAX package's pimsim over the JAX spec engine's events, report
    and timeline, with a real draft spec and self-drafted (``None``)."""
    import repro.pimsim as jsim
    import repro_torch.pimsim as tsim

    for draft in ("llama-1b", None):
        for mname, dname in (("llama-7b", "jetson-agx-orin-64gb"),
                             ("llama-1b", "iphone-15-pro")):
            sims = [pkg.replay_events(eng.events, pkg.MODELS[mname], pkg.DEVICES[dname],
                                      pkg.CDPIM,
                                      draft_model=draft and pkg.MODELS[draft])
                    for pkg, eng in ((tsim, teng), (jsim, jeng))]
            assert sims[0].to_json() == sims[1].to_json()
            assert sims[0].timeline == sims[1].timeline
            assert sims[0].spec_rounds == teng.schedule_report()["spec"]["rounds"]


@pytest.mark.parametrize("mode", MODES)
def test_spec_sampled_equals_plain_and_jax(models, mode):
    """temperature > 0: greedy drafts rarely match sampled targets, but the
    emitted stream rides the non-spec RNG lanes bit for bit."""
    plain, spec, jspec, teng, jeng = _serve_both(models, "llama", "llama", mode,
                                                 samplers=SAMPLERS)
    assert spec == plain == jspec
    assert teng.schedule_report()["spec"] == jeng.schedule_report()["spec"]
    assert _events(teng) == _events(jeng)


def test_spec_w8a8_target_equals_plain_and_jax(models):
    """Verify sub-steps share plain decode's single-token shape, so a W8A8
    target runs them through the same GEMV path: tokens stay identical."""
    plain, spec, jspec, teng, jeng = _serve_both(models, "llama_w8a8", "llama_w8a8", "HBCEM")
    assert spec == plain == jspec
    assert teng.schedule_report()["spec"] == jeng.schedule_report()["spec"]


def test_cross_draft_changes_cost_not_content(models):
    """A foreign draft (zamba2 smoke: recurrent state, so the anchor/catch-up
    protocol carries state it cannot truncate) gives the same tokens; only
    the rounds' accounting differs, and it equals JAX's."""
    plain, spec, jspec, teng, jeng = _serve_both(models, "llama", "zamba2", "HBCEM")
    assert spec == plain == jspec
    rep = teng.schedule_report()["spec"]
    assert rep == jeng.schedule_report()["spec"]
    assert rep["proposed"] > 0 and rep["draft_steps"] > 0
    self_rep = models["llama"][1].engine(chunk=4, spec=SpecConfig(
        draft=models["llama"][1], k=K))
    self_rep.serve(_treqs())
    assert self_rep.schedule_report()["spec"]["accepted"] > rep["accepted"]


def test_spec_k_opt_out_and_counters(models):
    jt, tt = models["llama"]
    prompts, budgets = PROMPTS[:3], [6, 6, 6]
    treqs = _treqs(prompts=prompts, budgets=budgets)
    treqs[1] = dataclasses.replace(treqs[1], spec_k=0)
    jreqs = _jreqs(prompts=prompts, budgets=budgets)
    jreqs[1] = dataclasses.replace(jreqs[1], spec_k=0)
    teng = tt.engine(chunk=4, spec=SpecConfig(draft=tt, k=K))
    tres = teng.serve(treqs)
    jres = jt.engine(chunk=4, spec=JSpec(draft=jt, k=K)).serve(jreqs)
    assert tres[1].spec_proposed == 0 and tres[1].spec_accepted == 0
    assert tres[0].spec_proposed > 0 and tres[2].spec_proposed > 0
    assert [(r.tokens, r.spec_proposed, r.spec_accepted) for r in tres] == \
        [(r.tokens, r.spec_proposed, r.spec_accepted) for r in jres]
    rep = teng.schedule_report()["spec"]
    assert sum(r.spec_proposed for r in tres) == rep["proposed"]
    assert sum(r.spec_accepted for r in tres) == rep["accepted"]
    solo = tt.engine(slots=1, chunk=4).serve(_treqs(prompts=prompts[1:2], budgets=[6]))[0]
    assert tres[1].tokens == solo.tokens
    _no_leaks(teng)


def test_events_record_each_rollout_and_its_catchup(models):
    """``spec_rollouts`` and ``spec_catchup_decodes`` count, per round, the
    lanes that rolled out and those whose catch-up fed one token (a decode
    step, like each chained feed); the paged pool's tables are
    ``ceil((max_len + spec_slack) / block_size)`` wide."""
    _, tt = models["llama"]
    eng = tt.engine(chunk=4, spec=SpecConfig(draft=tt, k=K))
    assert eng.pool.table_blocks == -(-(MAX_LEN + K) // eng.pool.block_size)
    assert tt.cache_pool(paged=False).table_blocks == 0
    sd, rounds = eng.spec_dec, []
    inner = sd.rollout

    def recorded(si, k, cfg):
        rounds[-1].append((len(sd._lanes[si].pending), int(k)))
        return inner(si, k, cfg)
    sd.rollout = recorded
    begin = sd.begin_round

    def begin_round():
        rounds.append([])
        begin()
    sd.begin_round = begin_round
    eng.serve(_treqs())
    spec_events = [e for e in eng.events if e.plan.spec]
    assert len(spec_events) == len(rounds) > 0
    assert [(e.spec_rollouts, e.spec_catchup_decodes, e.spec_draft_steps)
            for e in spec_events] == \
        [(len(r), sum(c == 1 for c, _ in r), sum(k - 1 for _, k in r)) for r in rounds]
    assert any(e.spec_catchup_decodes for e in spec_events)
    assert all(not e.spec_rollouts for e in eng.events if not e.plan.spec)


def test_spec_bit_identical_under_mid_decode_preemption(models):
    """A higher-priority arrival preempts a speculating lane mid-decode; the
    victim resumes (its draft lane resynced by a draft prefill of prompt +
    emitted tokens) bit-identically to solo runs, and the whole serve
    (tokens, states, events, spec report) equals the JAX spec engine's."""
    jt, tt = models["llama"]
    prompts, budgets = PROMPTS[:3], [6, 6, 4]
    solo = [tt.engine(slots=1, mode=Mode.HBCEM, chunk=4)
            .serve(_treqs(prompts=[p], budgets=[b]))[0].tokens
            for p, b in zip(prompts, budgets)]
    treqs = _treqs(prompts=prompts, budgets=budgets)
    treqs[2] = dataclasses.replace(treqs[2], priority=5)
    jreqs = _jreqs(prompts=prompts, budgets=budgets)
    jreqs[2] = dataclasses.replace(jreqs[2], priority=5)
    teng = tt.engine(slots=2, mode=Mode.HBCEM, chunk=4, spec=SpecConfig(draft=tt, k=2))
    tres = teng.serve(treqs)
    jeng = jt.engine(slots=2, mode=JMode.HBCEM, chunk=4, spec=JSpec(draft=jt, k=2))
    jres = jeng.serve(jreqs)
    assert sum(r.preemptions for r in tres) >= 1
    victim = next(i for i, r in enumerate(tres) if r.preemptions)
    assert tres[victim].spec_proposed > 0          # it was speculating when evicted
    assert [r.tokens for r in tres] == solo
    assert [(r.tokens, r.state.value, r.preemptions, r.admit_step, r.first_token_step,
             r.finish_step, r.spec_proposed, r.spec_accepted) for r in tres] == \
        [(r.tokens, r.state.value, r.preemptions, r.admit_step, r.first_token_step,
          r.finish_step, r.spec_proposed, r.spec_accepted) for r in jres]
    assert _events(teng) == _events(jeng)
    assert teng.schedule_report()["spec"] == jeng.schedule_report()["spec"]
    assert teng.health()["counters"] == jeng.health()["counters"]
    _no_leaks(teng)


def test_spec_k_without_a_spec_engine_is_ignored(models):
    """As in the JAX engine: ``spec_k`` caps a spec engine's depth and means
    nothing to an engine without a draft."""
    _, tt = models["llama"]
    plain = tt.engine(chunk=4).serve(_treqs())
    capped = tt.engine(chunk=4).serve(_treqs(spec_k=2))
    assert [r.tokens for r in capped] == [r.tokens for r in plain]


def test_invariants_hold_at_every_emission(models):
    """Live forks are part of the refcount audit, so it holds mid-round."""
    _, tt = models["llama"]
    eng = tt.engine(chunk=4, spec=SpecConfig(draft=tt, k=K))
    seen = []
    reqs = [dataclasses.replace(r, on_token=lambda t: seen.append(eng.pool.check_invariants()))
            for r in _treqs()]
    eng.serve(reqs)
    assert len(seen) == sum(BUDGETS)
    assert all(v == [] for v in seen)
    _no_leaks(eng)


# --------------------------------------------------------------------------
# constructor gates
# --------------------------------------------------------------------------


def test_spec_config_rejects_bad_k(models):
    _, tt = models["llama"]
    with pytest.raises(ValueError, match="k must be >= 1"):
        tt.engine(spec=SpecConfig(draft=tt, k=0))


def test_spec_rejects_vocab_mismatch(models):
    _, tt = models["llama"]
    alien = dataclasses.replace(tt, cfg=tt.cfg.replace(vocab_size=tt.cfg.vocab_size // 2))
    with pytest.raises(ValueError, match="vocab"):
        SpecDecoder(alien, tt, slots=2, max_len=MAX_LEN, k=2)


def test_spec_requires_fully_paged_target_pool(models):
    _, tt = models["llama"]
    pool = tt.cache_pool(slots=2, prefix_cache=False, paged=False, spec_slack=4)
    with pytest.raises(ValueError, match="fully paged"):
        Engine(tt.cfg, tt.params, max_len=MAX_LEN, slots=2, serving=tt, prefix_cache=False,
               pool=pool, spec=SpecConfig(draft=tt, k=2))


def test_spec_requires_slack_covering_k(models):
    _, tt = models["llama"]
    pool = tt.cache_pool(slots=2, prefix_cache=False, spec_slack=1)
    with pytest.raises(ValueError, match="spec_slack"):
        Engine(tt.cfg, tt.params, max_len=MAX_LEN, slots=2, serving=tt, prefix_cache=False,
               pool=pool, spec=SpecConfig(draft=tt, k=4))


# --------------------------------------------------------------------------
# the fork protocol on in-place pages
# --------------------------------------------------------------------------


def _pool_with_lane(tt, fill: int, block: int = 4):
    """A paged pool with one active lane of ``fill`` tokens (a partial write
    block when ``fill`` is off the block grid), its pages full of noise."""
    from repro_torch.serve.cache import CachePool

    pool = CachePool(tt.cfg, MAX_LEN, 2, prefix_cache=False, block_size=block,
                     spec_slack=K, device="cpu")
    req = GenerationRequest(prompt=list(range(1, fill + 1)), max_new_tokens=8)
    staging, _ = pool.stage_admission(req.prompt)
    staging = pool.staging_step_prep(staging, fill)
    kv = pool._kv
    g = torch.Generator().manual_seed(3)
    kv.pages["k_pages"].copy_(torch.randn(kv.pages["k_pages"].shape, generator=g))
    kv.pages["v_pages"].copy_(torch.randn(kv.pages["v_pages"].shape, generator=g))
    staging["pos"] = torch.tensor([fill], dtype=torch.int32)
    si = pool.alloc(req, 0, ctx=fill)
    pool.insert(si, staging)
    return pool, si


def _snapshot(pool, si):
    kv = pool._kv
    row = kv.block_tables[si].copy()
    live = [int(p) for p in row if p >= 0]
    return (row, kv.refcount.copy(), int(pool._pos[si]),
            kv.pages["k_pages"][:, live].clone(), kv.pages["v_pages"][:, live].clone())


@pytest.mark.parametrize("fill", [6, 8])     # a partial write block, a full one
def test_restore_after_a_written_branch_is_bit_identical(models, fill):
    """A verify branch appends 1 + K tokens in place; the first append into a
    page the fork references copies it first, so restore_lane gives back the
    same row, refcounts, fill and page contents, bit for bit."""
    _, tt = models["llama"]
    pool, si = _pool_with_lane(tt, fill)
    before = _snapshot(pool, si)
    fork = pool.fork_lane(si)
    assert pool.check_invariants() == []
    dparams = tt.decode_params
    for j in range(1 + K):
        cache = pool.views(span=1)
        assert pool.check_invariants() == []                  # mid-round, fork live
        _, cache = TM.decode_step(dparams, cache, torch.full((2, 1), 5 + j), tt.cfg)
        pool.commit(cache)
    if fill % 4:
        # the shared partial block was copied, the fork's page left alone
        wb = fill // 4
        assert pool._kv.block_tables[si, wb] != before[0][wb]
    pool.restore_lane(fork)
    after = _snapshot(pool, si)
    assert (after[0] == before[0]).all() and (after[1] == before[1]).all()
    assert after[2] == before[2]
    assert torch.equal(after[3], before[3]) and torch.equal(after[4], before[4])
    assert pool.check_invariants() == []
    with pytest.raises(EngineStateError):
        pool.restore_lane(fork)                                # spent once


def test_rollback_frees_each_page_once(models):
    _, tt = models["llama"]
    pool, si = _pool_with_lane(tt, 6)
    kv = pool._kv
    used = kv.pages_used()
    fork = pool.fork_lane(si)
    for j in range(1 + K):                   # 6 -> 10 tokens: one COW, one fresh block
        _, cache = TM.decode_step(tt.decode_params, pool.views(span=1),
                                  torch.full((2, 1), 7), tt.cfg)
        pool.commit(cache)
    assert kv.pages_used() == used + 2
    pool.rollback_lane(si, 6 + 1)            # keep one emitted token
    assert pool.check_invariants() == []
    pool.drop_fork(fork)
    assert pool.check_invariants() == []
    assert kv.pages_used() == used           # the fork's old write block went back
    assert int(pool._pos[si]) == 7
    with pytest.raises(EngineStateError):
        pool.drop_fork(fork)
    pool.retire(si)
    assert pool.check_invariants() == [] and kv.pages_used() == 0


def test_extract_lane_is_a_copy(models):
    """A draft rollout writes into the extracted lane; the pool's lane (KV and
    a hybrid's recurrent state) must not move until the round commits."""
    _, tz = models["zamba2"]
    sd = SpecDecoder(tz, tz, slots=2, max_len=MAX_LEN, k=K)
    req = GenerationRequest(prompt=[3, 1, 4, 1, 5], max_new_tokens=6)
    sd.ensure_lane(1, 0, req, req.prompt + [9], tz.cfg)
    before = {k: v.clone() for k, v in sd.pool.views().items()}
    drafts = sd.rollout(1, K, tz.cfg)
    assert len(drafts) == K
    after = sd.pool.views()
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    sd.finish_round(1, [drafts[0], 2])
    moved = sd.pool.views()
    assert not torch.equal(moved["ssd"], before["ssd"])
    assert int(sd.pool._pos[1]) == len(req.prompt) + 1
    assert sd.pool.check_invariants() == []

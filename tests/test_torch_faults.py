"""The port's robustness plane against the JAX package's, on the CPU.

Fault plans, the degradation ladder, priority preemption, deadlines and
cancellation (``repro_torch.serve.{faults,engine}``, ``core.dispatch``) are
held against ``repro.serve`` at the llama3-8b f32 smoke size. The JAX engine
runs at its default CPU backend, the ``reference`` floor of its ladder, which
is where the port's one-rung ladder always is: ``kernel_exc`` never fires
there, ``nan_logits`` never fires (nothing can degrade), ``alloc_fail`` and
``slow_step`` fire. Tokens, states, latency marks, ``ScheduleEvent`` streams,
``health()`` and ``schedule_report()`` must be equal, and every port run must
leave the pool audited clean. Then the port's own contracts: the ladder with
a ``"kernel"`` base (the card's), a step that raises, and the typed errors.
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
from repro.serve import faults as jfaults  # noqa: E402
from repro.serve.api import GenerationRequest as JReq  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import ScheduleEvent as JEvent  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core import interleave  # noqa: E402
from repro_torch.core.pim_modes import Mode  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.api import (FINISH_CANCELLED, FINISH_FAILED, FINISH_TIMEOUT,  # noqa: E402
                                   TERMINAL_STATES, GenerationRequest, RequestState)
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.errors import EngineStateError, KernelFault, PoolExhausted  # noqa: E402
from repro_torch.serve.faults import KINDS, Fault, FaultPlan  # noqa: E402
from repro_torch.serve.serving_model import ServingModel  # noqa: E402
from repro_torch.serve.spec import SpecConfig  # noqa: E402
from serving_refs import BUDGETS, MAX_LEN, PROMPTS  # noqa: E402

CHAOS_SEEDS = [0, 1, 2, 3, 4]
MODES = ["BLOCKED", "HBCEM", "LBIM"]


@pytest.fixture(scope="module")
def models():
    jcfg = get_config("llama3-8b", smoke=True).replace(dtype="float32",
                                                        param_dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    yield jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jp, tp
    jax.clear_caches()


def _jplan(plan):
    """The JAX package's copy of a port plan (fresh, unfired)."""
    if plan is None:
        return None
    return jfaults.FaultPlan(faults=[jfaults.Fault(f.kind, f.step, op=f.op, penalty=f.penalty)
                                     for f in plan.faults], seed=plan.seed)


def _reqs(cls, prompts=PROMPTS, budgets=BUDGETS, **kw):
    return [cls(prompt=list(p), max_new_tokens=b, **kw) for p, b in zip(prompts, budgets)]


def _result(r):
    return (r.tokens, r.finish_reason, r.state.value, r.error, r.prompt_len,
            r.reused_prefix_tokens, r.preemptions, r.arrival_step, r.admit_step,
            r.first_token_step, r.finish_step)


def _event(e):
    """The fields both engines record. The JAX engine's ``attempts`` and
    ``degraded``, which the port leaves out, must be its floor's constants."""
    if isinstance(e, JEvent):
        assert e.attempts == 1 and not e.degraded
    return (e.plan.label, e.plan.prefill_chunk, e.decode_batch, e.prefill_tokens, e.decode_ctx,
            e.reused_tokens, e.slow_penalty, e.kv_splits, e.mode,
            e.arrivals, e.queue_depth, e.emitted_tokens, e.first_tokens, e.idle_steps)


def _snapshot(eng, res):
    return ([_result(r) for r in res], [_event(e) for e in eng.events], eng.health(),
            eng.schedule_report().to_json())


def _failed_event(eng, res):
    """The one event marked failed; the FAILED requests end at its boundary."""
    [ev] = [e for e in eng.events if e.failed]
    assert {r.finish_step for r in res if r.state is RequestState.FAILED} == \
        {ev.clock + 1 + ev.slow_penalty}
    return ev


def _assert_no_leaks(eng):
    assert eng.pool.check_invariants() == []
    occ = eng.pool.occupancy()
    assert occ.slots_used == 0, "stuck slot(s) after serve()"
    assert occ.prefix_pins == 0, "retired slots still pin prefix pages"


def _run_both(models, mode, treqs, jreqs, plan=None, slots=2, params=None):
    """The same requests and plan through the port's engine and the JAX one.
    Returns (port engine, port results, port snapshot, JAX snapshot)."""
    jcfg, tcfg, jp, tp = models
    jparams, tparams = params if params is not None else (jp, tp)
    teng = Engine(tcfg, tparams, max_len=MAX_LEN, mode=Mode[mode], slots=slots, chunk=4,
                  fault_plan=plan)
    tres = teng.serve(treqs)
    jeng = JEngine(jcfg, jparams, max_len=MAX_LEN, mode=JMode[mode], slots=slots, chunk=4,
                   fault_plan=_jplan(plan))
    jres = jeng.serve(jreqs)
    assert all(r.state in TERMINAL_STATES for r in tres)
    _assert_no_leaks(teng)
    return teng, tres, _snapshot(teng, tres), _snapshot(jeng, jres)


@pytest.fixture(scope="module")
def baseline(models):
    """Fault-free port tokens per mode."""
    _, tcfg, _, tp = models
    return {m: [r.tokens for r in Engine(tcfg, tp, max_len=MAX_LEN, mode=Mode[m], slots=2,
                                         chunk=4).serve(_reqs(GenerationRequest))]
            for m in MODES}


# ===========================================================================
# chaos sweep
# ===========================================================================


def test_seeded_plans_equal_jax_draws():
    for seed in CHAOS_SEEDS + [7]:
        ours = FaultPlan.seeded(seed, horizon=20, n_faults=4)
        theirs = jfaults.FaultPlan.seeded(seed, horizon=20, n_faults=4)
        assert ours.to_json() == theirs.to_json()
    assert KINDS == jfaults.KINDS


@pytest.mark.chaos
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_seeded_plan_matches_jax(models, baseline, seed, mode):
    plan = FaultPlan.seeded(seed, horizon=20, n_faults=4)
    teng, tres, ours, theirs = _run_both(models, mode, _reqs(GenerationRequest), _reqs(JReq),
                                         plan)
    assert ours == theirs
    for r, ref in zip(tres, baseline[mode]):
        if r.state is RequestState.FINISHED:
            assert r.tokens == ref
        else:
            assert r.tokens == ref[:len(r.tokens)]
    rep = teng.schedule_report()
    assert rep["health"]["counters"]["injected_faults"] == plan.fired()
    assert plan.fired() + plan.pending() == len(plan.faults)
    # on the CPU no kernel is live, so no kernel fault fires and nothing degrades
    assert all(not (f.kind in ("kernel_exc", "nan_logits") and f.fired) for f in plan.faults)
    assert rep["degraded_steps"] == 0
    # the port's own stamps: each event's clock is where the step clock stood
    # (an idle event jumps it, any other adds 1 + its slow penalty); a failed
    # step is one failed attempt
    stood = np.cumsum([0] + [e.idle_steps or 1 + e.slow_penalty for e in teng.events])
    assert [e.clock for e in teng.events] == stood[:-1].tolist()
    assert sum(e.failed for e in teng.events) == rep["health"]["counters"]["retried_steps"]


@pytest.mark.chaos
def test_chaos_same_seed_replays_bit_identically(models):
    _, tcfg, _, tp = models

    def run():
        plan = FaultPlan.seeded(7, horizon=20, n_faults=4)
        eng = Engine(tcfg, tp, max_len=MAX_LEN, mode=Mode.LBIM, slots=2, chunk=4,
                     fault_plan=plan)
        res = eng.serve(_reqs(GenerationRequest))
        return _snapshot(eng, res), plan.fired()

    assert run() == run()


# ===========================================================================
# the ladder
# ===========================================================================


def test_ladder_exhaustion_from_nan_weights_fails_participants(models):
    """NaN weights make every logit NaN: the guard trips, the one-rung ladder
    cannot recover, the step's participants fail with a typed error and the
    engine returns (as the JAX engine at its reference floor)."""
    _, _, jp, tp = models
    jbad = dict(jp)
    jbad["final_norm"] = jax.tree_util.tree_map(lambda x: x * jnp.float32(float("nan")),
                                                jp["final_norm"])
    tbad = dict(tp)
    tbad["final_norm"] = {k: v * float("nan") for k, v in tp["final_norm"].items()}
    teng, tres, ours, theirs = _run_both(
        models, "HBCEM", _reqs(GenerationRequest, PROMPTS[:2], BUDGETS[:2]),
        _reqs(JReq, PROMPTS[:2], BUDGETS[:2]), params=(jbad, tbad))
    assert ours == theirs
    assert all(r.state is RequestState.FAILED and r.finish_reason == FINISH_FAILED and r.error
               for r in tres)
    h = teng.health()
    assert h["ladder"]["decode_attention"]["nan_trips"] >= 1
    assert h["counters"]["failures"] >= 1 and not h["degraded"]
    assert sum(e.failed for e in teng.events) == h["counters"]["failures"]


def test_port_ladder_on_the_card_has_one_rung(models):
    """The card's ladder: each op's one rung is the CUDA kernel, a kernel is
    live (so an injected kernel_exc fires) and there is no rung to degrade
    to. On the CPU no kernel is live."""
    _, tcfg, _, _ = models
    card = dispatch.DegradationLadder(tcfg, "cuda")
    assert {op: card.backend(op) for op in dispatch.LADDER_OPS} == \
        {"decode_attention": "kernel", "pim_gemv": "kernel"}
    assert all(card.kernel_live(op) for op in dispatch.LADDER_OPS)
    assert not hasattr(card, "degrade")
    card.record_fault("pim_gemv")
    card.record_nan()
    h = card.health()
    assert h["pim_gemv"] == {"backend": "kernel", "base": "kernel", "fallbacks": 0,
                             "nan_trips": 0, "kernel_faults": 1}
    assert h["decode_attention"]["nan_trips"] == 1
    cpu = dispatch.DegradationLadder(tcfg, "cpu")
    assert not any(cpu.kernel_live(op) for op in dispatch.LADDER_OPS)
    assert cpu.health()["decode_attention"]["backend"] == "reference"


def test_kernel_fault_takes_the_exhaustion_path(models, baseline, monkeypatch):
    """With a live kernel (the card's ladder, put on a CPU engine) an injected
    kernel_exc fails exactly that step's participants; the queued requests
    finish with the fault-free tokens, and nothing leaks."""
    _, tcfg, _, tp = models
    plan = FaultPlan(faults=[Fault("kernel_exc", 3, op="pim_gemv")])
    eng = Engine(tcfg, tp, max_len=MAX_LEN, mode=Mode.HBCEM, slots=2, chunk=4,
                 fault_plan=plan)
    eng.ladder = dispatch.DegradationLadder(tcfg, "cuda")   # counts only; runs nothing
    res = eng.serve(_reqs(GenerationRequest))
    assert plan.fired() == 1
    ev = _failed_event(eng, res)
    failed = [i for i, r in enumerate(res) if r.state is RequestState.FAILED]
    assert len(failed) == ev.decode_batch + (1 if ev.prefill_tokens else 0) >= 1
    for i, r in enumerate(res):
        if i in failed:
            assert r.finish_reason == FINISH_FAILED and "ladder exhausted" in r.error
            assert r.tokens == baseline["HBCEM"][i][:len(r.tokens)]
        else:
            assert r.state is RequestState.FINISHED and r.tokens == baseline["HBCEM"][i]
    h = eng.health()
    assert h["ladder"]["pim_gemv"]["kernel_faults"] == 1
    assert h["ladder"]["pim_gemv"]["fallbacks"] == 0 and not h["degraded"]
    assert h["counters"]["failures"] == 1 and h["counters"]["injected_faults"] == 1
    assert eng.last_step_error == "KernelFault: kernel fault in 'pim_gemv'"
    _assert_no_leaks(eng)


def test_step_that_raises_releases_verify_forks_once(models, baseline, monkeypatch):
    """An exception inside a verify round (the second verify position's
    decode raises once): the attempt restores every fork exactly once, the
    round is aborted, the step's participants fail, everything else finishes
    with the fault-free tokens, and both pools audit clean."""
    _, tcfg, _, tp = models
    sm = ServingModel.prepare(tcfg, tp, max_len=MAX_LEN, slots=2, device="cpu")
    eng = sm.engine(mode=Mode.HBCEM, chunk=4, spec=SpecConfig(draft=sm, k=2))
    real = interleave.decode_only_step
    calls = {"target": 0, "raised": False}
    released = []

    def flaky(params, cache, toks, cfg, *a, **kw):
        if toks.shape[0] == eng.slots and not calls["raised"]:
            calls["target"] += 1
            if eng.events and eng.events[-1].plan.decode and calls["target"] >= 4:
                calls["raised"] = True
                raise RuntimeError("injected step failure")
        return real(params, cache, toks, cfg, *a, **kw)

    for name in ("restore_lane", "drop_fork"):
        orig = getattr(eng.pool, name)

        def spend(fork, _orig=orig, _name=name):
            released.append((id(fork), _name))
            return _orig(fork)
        monkeypatch.setattr(eng.pool, name, spend)
    monkeypatch.setattr(interleave, "decode_only_step", flaky)
    aborted = []
    orig_abort = eng.spec_dec.abort_round
    monkeypatch.setattr(eng.spec_dec, "abort_round",
                        lambda: (aborted.append(1), orig_abort())[1])
    res = eng.serve(_reqs(GenerationRequest))
    assert calls["raised"]
    assert len(released) == len({fid for fid, _ in released})     # each fork spent once
    assert aborted == [1]
    ev = _failed_event(eng, res)
    assert ev.plan.spec and ev.spec_drafted
    failed = [i for i, r in enumerate(res) if r.state is RequestState.FAILED]
    assert len(failed) == ev.decode_batch + (1 if ev.prefill_tokens else 0)
    for i, r in enumerate(res):
        if i not in failed:
            assert r.state is RequestState.FINISHED and r.tokens == baseline["HBCEM"][i]
        else:
            assert r.tokens == baseline["HBCEM"][i][:len(r.tokens)]
    assert eng.health()["counters"]["failures"] == 1
    assert eng.last_step_error == "RuntimeError: injected step failure"
    _assert_no_leaks(eng)
    assert eng.spec_dec.pool.check_invariants() == []
    assert eng.spec_dec.pool.occupancy().slots_used == 0


# ===========================================================================
# preemption, alloc failure, occupancy
# ===========================================================================


def test_priority_preemption_resumes_bit_identical(models):
    _, tcfg, _, tp = models
    prompts, budgets = PROMPTS[:3], [6, 6, 4]
    solo = [Engine(tcfg, tp, max_len=MAX_LEN, mode=Mode.HBCEM, slots=1, chunk=4)
            .serve(_reqs(GenerationRequest, [p], [b]))[0].tokens
            for p, b in zip(prompts, budgets)]
    treqs = _reqs(GenerationRequest, prompts, budgets)
    treqs[2] = dataclasses.replace(treqs[2], priority=5)
    jreqs = _reqs(JReq, prompts, budgets)
    jreqs[2] = dataclasses.replace(jreqs[2], priority=5)
    teng, tres, ours, theirs = _run_both(models, "HBCEM", treqs, jreqs)
    assert ours == theirs
    assert all(r.state is RequestState.FINISHED for r in tres)
    assert sum(r.preemptions for r in tres) >= 1
    assert [r.tokens for r in tres] == solo
    assert teng.health()["counters"]["preemptions"] >= 1


def test_injected_alloc_failure_heals_by_preemption(models, baseline):
    plan = FaultPlan(faults=[Fault("alloc_fail", 1), Fault("alloc_fail", 4)])
    teng, tres, ours, theirs = _run_both(models, "HBCEM", _reqs(GenerationRequest),
                                         _reqs(JReq), plan)
    assert ours == theirs
    assert all(r.state is RequestState.FINISHED for r in tres)
    assert [r.tokens for r in tres] == baseline["HBCEM"]
    assert plan.fired() >= 1


def test_preempt_heavy_run_leaves_no_dangling_blocks(models):
    plan = FaultPlan(faults=[Fault("alloc_fail", s) for s in (1, 2, 3, 5, 8)])
    _, tres, ours, theirs = _run_both(models, "LBIM", _reqs(GenerationRequest), _reqs(JReq),
                                      plan)
    assert ours == theirs
    assert all(r.done for r in tres)
    assert sum(r.preemptions for r in tres) >= 1


def test_pool_exhausted_carries_occupancy(models):
    _, tcfg, _, tp = models
    eng = Engine(tcfg, tp, max_len=MAX_LEN, mode=Mode.HBCEM, slots=1, chunk=4)
    req = GenerationRequest(prompt=[1, 2, 3], max_new_tokens=4, priority=3)
    si = eng.pool.alloc(req, 0)
    assert eng.pool.get(si).priority == 3
    with pytest.raises(PoolExhausted) as ei:
        eng.pool.alloc(req, 1)
    occ = ei.value.occupancy
    assert occ.slots_used == occ.slots_total == 1 and occ.slots_free == 0
    assert not ei.value.injected
    assert "slots_used" in occ.to_json()
    eng.pool.retire(0)
    _assert_no_leaks(eng)


def test_free_counts_return_to_baseline_across_serves(models):
    _, tcfg, _, tp = models
    eng = Engine(tcfg, tp, max_len=MAX_LEN, mode=Mode.HBCEM, slots=2, chunk=4)
    base = eng.pool.occupancy()
    eng.serve(_reqs(GenerationRequest))
    mid = eng.pool.occupancy()
    eng.serve(_reqs(GenerationRequest))   # the second run reuses stored prefix pages
    end = eng.pool.occupancy()
    assert base.slots_used == mid.slots_used == end.slots_used == 0
    assert end.pages_used == mid.pages_used
    assert eng.pool.check_invariants() == []


# ===========================================================================
# deadlines and cancellation
# ===========================================================================


def test_ttft_deadline_times_out_queued_request(models):
    treqs = _reqs(GenerationRequest, PROMPTS[:3], [4, 4, 4])
    treqs[1] = dataclasses.replace(treqs[1], ttft_deadline=1)
    jreqs = _reqs(JReq, PROMPTS[:3], [4, 4, 4])
    jreqs[1] = dataclasses.replace(jreqs[1], ttft_deadline=1)
    teng, tres, ours, theirs = _run_both(models, "BLOCKED", treqs, jreqs, slots=1)
    assert ours == theirs
    assert tres[1].state is RequestState.TIMED_OUT and tres[1].finish_reason == FINISH_TIMEOUT
    assert tres[1].tokens == []
    assert tres[0].state is tres[2].state is RequestState.FINISHED
    assert teng.health()["counters"]["timeouts"] == 1


def test_total_deadline_keeps_partial_tokens(models, baseline):
    treqs = _reqs(GenerationRequest)
    treqs[1] = dataclasses.replace(treqs[1], deadline=4)
    jreqs = _reqs(JReq)
    jreqs[1] = dataclasses.replace(jreqs[1], deadline=4)
    plan = FaultPlan(faults=[Fault("slow_step", 1, penalty=6)])
    _, tres, ours, theirs = _run_both(models, "HBCEM", treqs, jreqs, plan)
    assert ours == theirs
    assert tres[1].state is RequestState.TIMED_OUT
    assert tres[1].tokens == baseline["HBCEM"][1][:len(tres[1].tokens)]
    assert len(tres[1].tokens) < len(baseline["HBCEM"][1])


def test_cancel_mid_stream_keeps_emitted_tokens(models, baseline):
    jcfg, tcfg, jp, tp = models
    out = {}
    for name, eng_cls, req_cls, cfg, params, mode in (
            ("port", Engine, GenerationRequest, tcfg, tp, Mode.LBIM),
            ("jax", JEngine, JReq, jcfg, jp, JMode.LBIM)):
        eng = eng_cls(cfg, params, max_len=MAX_LEN, mode=mode, slots=2, chunk=4)
        seen = []

        def tap(tok, eng=eng, seen=seen):
            seen.append(tok)
            if len(seen) == 3:
                eng.cancel(1)

        reqs = _reqs(req_cls)
        reqs[1] = dataclasses.replace(reqs[1], on_token=tap)
        res = eng.serve(reqs)
        out[name] = (eng, res, _snapshot(eng, res))
    assert out["port"][2] == out["jax"][2]
    eng, res, _ = out["port"]
    assert res[1].state is RequestState.CANCELLED and res[1].finish_reason == FINISH_CANCELLED
    assert res[1].tokens == baseline["LBIM"][1][:len(res[1].tokens)]
    assert all(r.state is RequestState.FINISHED and r.tokens == baseline["LBIM"][i]
               for i, r in enumerate(res) if i != 1)
    assert eng.health()["counters"]["cancellations"] == 1
    _assert_no_leaks(eng)


def test_cancel_outside_serve_is_a_state_error(models):
    _, tcfg, _, tp = models
    eng = Engine(tcfg, tp, max_len=MAX_LEN, mode=Mode.HBCEM, slots=2, chunk=4)
    with pytest.raises(EngineStateError):
        eng.cancel(0)


def test_typed_faults_expose_injection_provenance():
    f = KernelFault("decode_attention", "boom", injected=True)
    assert f.injected and f.op == "decode_attention"
    assert set(KINDS) == {"alloc_fail", "kernel_exc", "nan_logits", "slow_step"}
    plan = FaultPlan.seeded(3, horizon=10)
    j = plan.to_json()
    assert j["seed"] == 3 and len(j["faults"]) == len(plan.faults)

"""The port's traffic plane against the JAX package's, on the CPU.

``repro_torch.serve.traffic`` (seeded traces, nearest-rank percentiles, the
step-domain latency summary), the step policies of ``core.pim_modes`` and the
engine under arrivals are held against ``repro.serve.traffic``,
``repro.core.pim_modes`` and the JAX engine at the llama3-8b f32 smoke size:
traces equal as JSON, policy choices equal on the same signals, and tokens,
latency marks, ``ScheduleEvent`` streams and ``schedule_report()`` equal
under every policy. Then the reference suite's own traffic contracts inside
the port: tokens do not depend on the policy, idle gaps jump the clock, TTFT
deadlines run from arrival, a preempted request's queue wait counts once, and
the spec-aware admission refill.
"""
import dataclasses
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import pim_modes as jpm  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import traffic as jtraffic  # noqa: E402
from repro.serve.api import GenerationRequest as JReq  # noqa: E402
from repro.serve.api import GenerationResult as JResult  # noqa: E402
from repro.serve.api import RequestState as JState  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import ScheduleEvent as JEvent  # noqa: E402
from repro.serve.serving_model import ServingModel as JServing  # noqa: E402
from repro.serve.spec import SpecConfig as JSpec  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.pim_modes import (Mode, SloAwarePolicy, StaticPolicy,  # noqa: E402
                                        StepSignals, resolve_policy)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import traffic  # noqa: E402
from repro_torch.serve.api import GenerationRequest, GenerationResult, RequestState  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.serving_model import ServingModel  # noqa: E402
from repro_torch.serve.spec import SpecConfig  # noqa: E402

POLICIES = ["blocked", "hbcem", "lbim", "auto"]


@pytest.fixture(scope="module")
def models():
    jcfg = get_config("llama3-8b", smoke=True).replace(dtype="float32",
                                                        param_dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    yield jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jp, tp
    jax.clear_caches()


def _cfg_kw(vocab, **kw):
    base = dict(n_requests=5, seed=11, rate=0.3, prompt_len=(3, 9), max_new=(3, 6),
                vocab=vocab)
    base.update(kw)
    return base


def _jreqs(trace_json):
    """The JAX package's requests for a port trace (through the JAX trace)."""
    return jtraffic.TrafficTrace.from_json(trace_json).to_requests()


def _result(r):
    return (r.tokens, r.finish_reason, r.state.value, r.error, r.preemptions, r.arrival_step,
            r.admit_step, r.first_token_step, r.finish_step)


def _event(e):
    """The fields both engines record; the JAX engine's ``attempts`` (which
    the port leaves out) must be its floor's constant 1."""
    if isinstance(e, JEvent):
        assert e.attempts == 1
    return (e.plan.label, e.decode_batch, e.prefill_tokens, e.decode_ctx, e.reused_tokens,
            e.slow_penalty, e.mode, e.arrivals, e.queue_depth, e.emitted_tokens,
            e.first_tokens, e.idle_steps)


def _engines(models, policy, slots=2):
    jcfg, tcfg, jp, tp = models
    kw = dict(max_len=64, slots=slots, chunk=4)
    if policy == "auto":
        return (Engine(tcfg, tp, step_policy=SloAwarePolicy(), **kw),
                JEngine(jcfg, jp, step_policy=jpm.SloAwarePolicy(), **kw))
    return (Engine(tcfg, tp, mode=Mode(policy), **kw),
            JEngine(jcfg, jp, mode=jpm.Mode(policy), **kw))


def _serve_both(models, policy, treqs, jreqs, slots=2):
    teng, jeng = _engines(models, policy, slots)
    tres, jres = teng.serve(treqs), jeng.serve(jreqs)
    assert teng.pool.check_invariants() == [] and teng.pool.occupancy().slots_used == 0
    ours = ([_result(r) for r in tres], [_event(e) for e in teng.events],
            teng.schedule_report().to_json())
    theirs = ([_result(r) for r in jres], [_event(e) for e in jeng.events],
              jeng.schedule_report().to_json())
    return teng, tres, ours, theirs


# ------------------------------------------------------------------ generator


@pytest.mark.parametrize("kw", [
    dict(),
    dict(seed=5, rate=0.4, prompt_len=(2, 12), max_new=(2, 8), ttft_deadline=40,
         deadline=90),
    dict(process="fixed", gap=3, priorities=(0, 0, 1)),
    dict(n_requests=16, seed=0, rate=0.25, prompt_len=(32, 256), max_new=(8, 48),
         priorities=(0, 0, 1)),
])
def test_generate_equals_jax_and_round_trips(tmp_path, kw):
    cfg_kw = _cfg_kw(101, **kw)
    ours = traffic.generate(traffic.TrafficConfig(**cfg_kw))
    theirs = jtraffic.generate(jtraffic.TrafficConfig(**cfg_kw))
    assert ours.to_json() == theirs.to_json()
    p = tmp_path / "trace.json"
    ours.save(p)
    assert traffic.TrafficTrace.load(p).to_json() == ours.to_json()
    assert jtraffic.TrafficTrace.load(p).to_json() == theirs.to_json()

    def fields(r):
        return (r.prompt, r.max_new_tokens, r.priority, r.ttft_deadline, r.deadline,
                r.spec_k, r.arrival_step, r.sampling.seed, r.sampling.temperature)
    reqs = ours.to_requests(spec_k=2)
    assert [fields(r) for r in reqs] == [fields(r) for r in theirs.to_requests(spec_k=2)]
    assert [r.sampling.seed for r in reqs] == [r.seed for r in ours.requests]
    arr = [r.arrival_step for r in reqs]
    assert arr == sorted(arr) and arr[0] >= 0


def test_generate_validates_like_jax():
    for bad in (dict(n_requests=0), dict(process="bursty"), dict(rate=0.0),
                dict(process="fixed", gap=-1), dict(prompt_len=(0, 3)), dict(vocab=1),
                dict(priorities=())):
        with pytest.raises(ValueError):
            traffic.generate(traffic.TrafficConfig(**{**_cfg_kw(101), **bad}))
        with pytest.raises(ValueError):
            jtraffic.generate(jtraffic.TrafficConfig(**{**_cfg_kw(101), **bad}))


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert traffic.percentile(xs, 50) == 50
    assert traffic.percentile(xs, 95) == 95
    assert traffic.percentile(xs, 99) == 99
    assert traffic.percentile([7], 99) == 7
    assert traffic.percentile([], 50) is None
    assert isinstance(traffic.percentile([3, 1, 2], 95), int)
    rng = np.random.default_rng(0)
    for n, p in itertools.product((1, 2, 7, 33), (0, 1, 50, 95, 99, 100)):
        vals = rng.integers(0, 50, size=n).tolist()
        assert traffic.percentile(vals, p) == jtraffic.percentile(vals, p)


def test_latency_summary_equals_jax():
    """The same latency marks in both packages' results give the same
    summary, SLO attainment included."""
    rng = np.random.default_rng(3)
    states = ["finished", "finished", "timed_out", "cancelled", "failed", "finished"]
    ours, theirs, treqs, jreqs = [], [], [], []
    for i, st in enumerate(states * 3):
        arr = int(rng.integers(0, 20))
        marks = dict(arrival_step=arr, admit_step=arr + int(rng.integers(0, 5)),
                     first_token_step=None if st == "timed_out" else arr + int(rng.integers(1, 9)),
                     finish_step=arr + int(rng.integers(9, 40)))
        toks = list(range(int(rng.integers(1, 6))))
        ours.append(GenerationResult(tokens=toks, state=RequestState(st), **marks))
        theirs.append(JResult(tokens=toks, state=JState(st), **marks))
        dl = dict(ttft_deadline=4 if i % 2 else None, deadline=30 if i % 3 else None)
        treqs.append(GenerationRequest(prompt=[1], max_new_tokens=5, **dl))
        jreqs.append(JReq(prompt=[1], max_new_tokens=5, **dl))
    assert traffic.latency_summary(ours) == jtraffic.latency_summary(theirs)
    got = traffic.latency_summary(ours, treqs)
    assert got == jtraffic.latency_summary(theirs, jreqs)
    assert 0 < got["slo"]["met"] < got["slo"]["declared"] <= len(ours)
    assert traffic.latency_summary([]) == jtraffic.latency_summary([])


# ----------------------------------------------------------------- step policy


SIGNALS = [dict(clock=5, active=2, free=0, queue_depth=1, pending_arrivals=0,
                stream_remaining=6, backlog_prefill_tokens=8, backlog_decode_tokens=4),
           dict(clock=5, active=2, free=0, queue_depth=0, pending_arrivals=3,
                stream_remaining=0, backlog_prefill_tokens=0, backlog_decode_tokens=0),
           dict(clock=5, active=1, free=1, queue_depth=0, pending_arrivals=0,
                stream_remaining=3, backlog_prefill_tokens=0, backlog_decode_tokens=0),
           dict(clock=5, active=2, free=0, queue_depth=1, pending_arrivals=0,
                stream_remaining=6, backlog_prefill_tokens=8, backlog_decode_tokens=4,
                min_ttft_slack=4),
           dict(clock=5, active=2, free=0, queue_depth=1, pending_arrivals=0,
                stream_remaining=6, backlog_prefill_tokens=8, backlog_decode_tokens=4,
                min_ttft_slack=40)]


@pytest.mark.parametrize("margin", [0, 10])
def test_slo_aware_policy_equals_jax(margin):
    ours, theirs = SloAwarePolicy(slack_margin=margin), jpm.SloAwarePolicy(slack_margin=margin)
    for sig in SIGNALS:
        a, b = ours.choose(StepSignals(**sig)), theirs.choose(jpm.StepSignals(**sig))
        assert (a.mode.value, a.allow_spec) == (b.mode.value, b.allow_spec)
    c = ours.choose(StepSignals(**SIGNALS[0]))
    assert c.mode is Mode.LBIM and not c.allow_spec
    assert ours.choose(StepSignals(**SIGNALS[1])).mode is Mode.HBCEM
    assert ours.choose(StepSignals(**SIGNALS[4])).allow_spec == (margin == 10)
    assert not ours.choose(StepSignals(**SIGNALS[3])).allow_spec


def test_resolve_policy_coercions():
    assert isinstance(resolve_policy("auto"), SloAwarePolicy)
    p = resolve_policy("lbim")
    assert isinstance(p, StaticPolicy) and p.mode is Mode.LBIM and p.name == "lbim"
    assert resolve_policy(Mode.BLOCKED).mode is Mode.BLOCKED
    assert resolve_policy(None).mode is Mode.HBCEM
    assert resolve_policy(None, Mode.LBIM).mode is Mode.LBIM
    pol = SloAwarePolicy(slack_margin=3)
    assert resolve_policy(pol) is pol
    assert resolve_policy("hbcem").choose(StepSignals(**SIGNALS[0])).mode is Mode.HBCEM
    with pytest.raises(ValueError):
        resolve_policy("warp-speed")


# --------------------------------------------------------- engine under arrivals


@pytest.fixture(scope="module")
def policy_runs(models):
    """Each policy over one trace with deadlines, through both engines."""
    _, tcfg, _, _ = models
    trace = traffic.generate(traffic.TrafficConfig(**_cfg_kw(tcfg.vocab_size,
                                                             ttft_deadline=100,
                                                             deadline=300)))
    return {p: _serve_both(models, p, trace.to_requests(), _jreqs(trace.to_json()))
            for p in POLICIES}


@pytest.mark.parametrize("policy", POLICIES)
def test_engine_under_arrivals_matches_jax(policy_runs, policy):
    teng, tres, ours, theirs = policy_runs[policy]
    assert ours == theirs
    assert all(r.state is RequestState.FINISHED for r in tres)
    rep = teng.schedule_report()
    assert rep["arrivals"] == len(tres)
    assert set(rep["mode_steps"]) <= {"hbcem", "lbim", "blocked"}
    if policy == "auto":
        assert rep["mode_steps"].get("lbim", 0) > 0


def test_tokens_identical_across_policies(policy_runs):
    toks = {p: [r.tokens for r in policy_runs[p][1]] for p in POLICIES}
    assert all(t == toks["blocked"] for t in toks.values())


def test_same_seed_replay_is_bit_identical(models, policy_runs):
    _, tcfg, _, _ = models
    trace = traffic.generate(traffic.TrafficConfig(**_cfg_kw(tcfg.vocab_size,
                                                             ttft_deadline=100,
                                                             deadline=300)))
    teng, _ = _engines(models, "auto")
    res = teng.serve(trace.to_requests())
    again = ([_result(r) for r in res], [_event(e) for e in teng.events],
             teng.schedule_report().to_json())
    assert again == policy_runs["auto"][2]


def test_arrival_plane_semantics(models):
    _, tcfg, _, _ = models
    trace = traffic.generate(traffic.TrafficConfig(**_cfg_kw(tcfg.vocab_size, rate=0.1)))
    teng, tres, ours, theirs = _serve_both(models, "hbcem", trace.to_requests(),
                                           _jreqs(trace.to_json()))
    assert ours == theirs
    for rq, r in zip(trace.requests, tres):
        assert r.state is RequestState.FINISHED and r.arrival_step == rq.arrival_step
        assert r.admit_step >= r.arrival_step
        assert r.first_token_step > r.arrival_step and r.finish_step >= r.first_token_step
    rep = teng.schedule_report()
    assert rep["arrivals"] == len(tres)
    assert rep["idle_steps"] > 0
    assert sum(e.idle_steps for e in teng.events) == rep["idle_steps"]


def test_ttft_deadline_measured_from_arrival(models):
    def reqs(cls):
        return [cls(prompt=[1, 2, 3], max_new_tokens=3),
                cls(prompt=[4, 5, 6], max_new_tokens=3, arrival_step=12, ttft_deadline=10)]
    _, tres, ours, theirs = _serve_both(models, "hbcem", reqs(GenerationRequest), reqs(JReq))
    assert ours == theirs
    assert tres[1].state is RequestState.FINISHED
    assert tres[1].ttft_steps is not None and tres[1].ttft_steps <= 10


def test_queue_wait_not_double_counted_after_preemption(models):
    def reqs(cls):
        return [cls(prompt=[1] * 6, max_new_tokens=12, priority=0),
                cls(prompt=[2] * 6, max_new_tokens=4, priority=5, arrival_step=4)]
    _, tres, ours, theirs = _serve_both(models, "hbcem", reqs(GenerationRequest), reqs(JReq),
                                        slots=1)
    assert ours == theirs
    assert tres[0].preemptions >= 1
    assert tres[0].state is tres[1].state is RequestState.FINISHED
    assert tres[0].admit_step is not None and tres[0].admit_step < 4
    assert tres[0].queue_wait_steps == tres[0].admit_step - tres[0].arrival_step


def test_spec_refill_sustains_admission_quantum(models):
    """Speculating lanes emit up to k+1 tokens a step, so the refill scales
    the admission quantum with emitted tokens: larger quanta beside live
    decodes, the same tokens. The boosted schedule equals the JAX spec
    engine's."""
    jcfg, tcfg, jp, tp = models
    sm = ServingModel.prepare(tcfg, tp, max_len=96, slots=2, device="cpu")
    trace = traffic.generate(traffic.TrafficConfig(
        n_requests=6, seed=3, rate=0.5, prompt_len=(12, 20), max_new=(8, 12),
        vocab=tcfg.vocab_size))

    def quanta(refill: bool):
        eng = sm.engine(slots=2, chunk=4, mode=Mode.HBCEM, spec=SpecConfig(draft=sm, k=3))
        eng.spec_refill = refill
        res = eng.serve(trace.to_requests())
        assert all(r.state is RequestState.FINISHED for r in res)
        assert eng.pool.check_invariants() == []
        return [e.prefill_tokens for e in eng.events if e.prefill_tokens and e.decode_batch], \
            res, eng

    boosted, res_on, eng_on = quanta(True)
    plain, res_off, _ = quanta(False)
    assert [r.tokens for r in res_on] == [r.tokens for r in res_off]
    assert boosted and max(boosted) > max(plain or [0])
    jsm = JServing.prepare(jcfg, jp, max_len=96, slots=2)
    jeng = jsm.engine(slots=2, chunk=4, mode=jpm.Mode.HBCEM, spec=JSpec(draft=jsm, k=3))
    jres = jeng.serve(_jreqs(trace.to_json()))
    assert [_result(r) for r in res_on] == [_result(r) for r in jres]
    assert [_event(e) for e in eng_on.events] == [_event(e) for e in jeng.events]


def test_schedule_report_latency_sections(policy_runs):
    teng, tres, _, _ = policy_runs["auto"]
    rep = teng.schedule_report()
    assert sum(rep["mode_steps"].values()) + sum(1 for e in teng.events if e.idle_steps) \
        == rep["steps"]
    lat = rep["latency"]
    for sect in ("ttft_steps", "tpot_steps", "queue_wait_steps"):
        assert {"p50", "p95", "p99"} <= set(lat[sect])
    assert lat["slo"]["declared"] == len(tres)
    assert 0.0 <= lat["slo"]["attainment"] <= 1.0
    assert lat["states"]["finished"] == len(tres)
    for key in ("retried_step_attempts", "degraded_steps", "slow_penalty_steps", "health",
                "idle_steps"):
        assert key in rep

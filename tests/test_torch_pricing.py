"""Pricing the port's engine events with the port's pimsim, against the JAX
package pricing the JAX engine's events, on the CPU (llama3-8b smoke, f32).

Each serve runs once in both packages (module-scoped) with the JAX suite's
request sets and engine shapes (``MAX_LEN`` 64, 2 slots, 4-token chunks).
``repro_torch.pimsim.replay_events`` over the port engine's events must give
the JAX ``replay_events``' report over the JAX engine's events exactly
(``to_json()`` and the per-event timeline compared with ``==``; both are the
same Python arithmetic over equal event fields), and so must
``serve.traffic.priced_latency``, ``wave_baseline_report`` and the priced
``wave_baseline_events``. The port's events carry no ``attempts`` or
``degraded``; the replay reads them as 1 and ``False``, the JAX engine's
values at its CPU floor. Then the JAX suite's pricing contracts on the port's
own events: the continuous schedule beats the wave baseline
(``test_continuous_batching.py:69``), LBIM prices no worse than BLOCKED
(:126), prefix reuse prices the skipped prefill (``test_cache_pool.py:252``),
a slow step stalls the timeline (``test_faults.py:153-160``; the port's
one-rung ladder retries nothing, so the plan is a slow step alone), the
report survives JSON (``test_serving_api.py:227``), and replays price
equally and idle events cost nothing (``test_traffic.py:150,187,272``). The
JAX engines' compiles are most of this file's time, so each serve runs once
and the tests share them; the spec engine's rounds are priced in
``tests/test_torch_spec.py``, on the spec engines that file already runs in
both packages.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.pimsim as J  # noqa: E402
import repro_torch.pimsim as T  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core import pim_modes as jpm  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
from repro.serve import traffic as jtraffic  # noqa: E402
from repro.serve.api import GenerationRequest as JReq  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import pim_modes as tpm  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve import faults as tfaults  # noqa: E402
from repro_torch.serve import traffic as ttraffic  # noqa: E402
from repro_torch.serve.api import GenerationRequest, RequestState  # noqa: E402
from serving_refs import BUDGETS, MAX_LEN, PROMPTS  # noqa: E402

SHARED = [7, 3, 9, 4, 11, 2, 6, 8]                   # tests/test_cache_pool.py:204
TAILS = [[10 + i, 20 + i, 5] for i in range(5)]
# tests/test_traffic.py's trace at its sparse rate (idle gaps), with its deadlines,
# served under the SLO-aware policy
TRACE = dict(n_requests=5, seed=11, rate=0.1, prompt_len=(3, 9), max_new=(3, 6))
PRICES = [("llama-1b", "jetson-agx-orin-64gb"), ("llama-7b", "iphone-15-pro")]
DESIGNS = ["cd-pim", "attacc-lpddr", "cd-pim-fixed-kv"]


@pytest.fixture(scope="module")
def runs():
    """Every serve of this file in both packages: name -> (port engine, port
    results, JAX engine, JAX results); ``prefix_False`` in the port only."""
    jcfg = get_config("llama3-8b", smoke=True).replace(dtype="float32",
                                                        param_dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    trace = ttraffic.generate(ttraffic.TrafficConfig(
        vocab=tcfg.vocab_size, ttft_deadline=100, deadline=300, **TRACE))

    def reqs(prompts, budgets):
        return ([GenerationRequest(prompt=list(p), max_new_tokens=b)
                 for p, b in zip(prompts, budgets)],
                [JReq(prompt=list(p), max_new_tokens=b) for p, b in zip(prompts, budgets)])

    def from_trace(tr):
        return tr.to_requests(), jtraffic.TrafficTrace.from_json(tr.to_json()).to_requests()

    def plain(mode, **kw):
        return (lambda: tengine.Engine(tcfg, tp, max_len=MAX_LEN, slots=2, chunk=4,
                                       mode=tpm.Mode(mode), **{k: v[0] for k, v in kw.items()}),
                lambda: jengine.Engine(jcfg, jp, max_len=MAX_LEN, slots=2, chunk=4,
                                       mode=jpm.Mode(mode), **{k: v[1] for k, v in kw.items()}))

    def slow_plan():
        return {"fault_plan": (tfaults.FaultPlan(faults=[tfaults.Fault("slow_step", 3,
                                                                       penalty=2)]),
                               jfaults.FaultPlan(faults=[jfaults.Fault("slow_step", 3,
                                                                       penalty=2)]))}

    base = reqs(PROMPTS, BUDGETS)
    shared = reqs([SHARED + t for t in TAILS], [4] * len(TAILS))
    table = {
        **{m: (plain(m), base) for m in ("blocked", "hbcem", "lbim")},
        "hbcem_slow": (plain("hbcem", **slow_plan()), base),
        "prefix_True": (plain("hbcem", prefix_cache=(True, True)), shared),
        # the cold twin serves in the port only: its price is the contract's
        # yardstick, and the JAX twin would add a compile for no new path
        "prefix_False": ((plain("hbcem", prefix_cache=(False, False))[0], None), shared),
        "trace": ((lambda: tengine.Engine(tcfg, tp, max_len=MAX_LEN, slots=2, chunk=4,
                                               step_policy=tpm.SloAwarePolicy()),
                        lambda: jengine.Engine(jcfg, jp, max_len=MAX_LEN, slots=2, chunk=4,
                                               step_policy=jpm.SloAwarePolicy())),
                  from_trace(trace)),
    }
    out = {}
    for name, ((make_t, make_j), (treqs, jreqs)) in table.items():
        teng, jeng = make_t(), make_j and make_j()
        tres, jres = teng.serve(treqs), jeng and jeng.serve(jreqs)
        assert jres is None or [r.tokens for r in tres] == [r.tokens for r in jres], name
        out[name] = (teng, tres, jeng, jres)
    return out


def _price(events, mname, dname, design, draft=None, pkg=T):
    return pkg.replay_events(events, pkg.MODELS[mname], pkg.DEVICES[dname],
                             pkg.DESIGNS[design],
                             draft_model=None if draft is None else pkg.MODELS[draft])


def _same_price(teng, jeng, mname, dname, design, draft=None):
    """The port's replay of the port's events equals the JAX replay of the
    JAX events, report and timeline."""
    t = _price(teng.events, mname, dname, design, draft)
    j = _price(jeng.events, mname, dname, design, draft, pkg=J)
    assert t.to_json() == j.to_json()
    assert t.timeline == j.timeline
    return t


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("mname,dname", PRICES)
@pytest.mark.parametrize("name", ["blocked", "hbcem", "lbim", "hbcem_slow", "prefix_True",
                                  "trace"])
def test_replay_equals_jax(runs, name, mname, dname, design):
    teng, _, jeng, _ = runs[name]
    _same_price(teng, jeng, mname, dname, design)


def test_events_price_with_the_jax_floor_defaults(runs):
    """The port's events have no ``attempts``/``degraded``: priced as 1 and
    False, they retry and degrade nothing, as the JAX events at its floor."""
    teng, _, jeng, _ = runs["hbcem_slow"]
    assert not any(hasattr(e, "attempts") or hasattr(e, "degraded") for e in teng.events)
    assert all(e.attempts == 1 and not e.degraded for e in jeng.events)
    rep = _price(teng.events, "llama-1b", "jetson-agx-orin-64gb", "cd-pim")
    assert rep.retried_attempts == 0 and rep.degraded_steps == 0


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_wave_baseline_equals_jax(slots):
    lens = [len(p) for p in PROMPTS]
    assert (tengine.wave_baseline_report(lens, BUDGETS, slots)
            == jengine.wave_baseline_report(lens, BUDGETS, slots))
    for mode in ("blocked", "hbcem", "lbim"):
        tev = tengine.wave_baseline_events(lens, BUDGETS, slots, tpm.Mode(mode))
        jev = jengine.wave_baseline_events(lens, BUDGETS, slots, jpm.Mode(mode))
        assert ([(e.plan.label, e.decode_batch, e.prefill_tokens, e.decode_ctx) for e in tev]
                == [(e.plan.label, e.decode_batch, e.prefill_tokens, e.decode_ctx)
                    for e in jev])
        t = _price(tev, "llama-1b", "jetson-agx-orin-64gb", "cd-pim")
        j = _price(jev, "llama-1b", "jetson-agx-orin-64gb", "cd-pim", pkg=J)
        assert (t.to_json(), t.timeline) == (j.to_json(), j.timeline)


def test_schedule_beats_wave_baseline(runs):
    """test_continuous_batching.py:69 on the port's events."""
    lens = [len(p) for p in PROMPTS]
    wave = tengine.wave_baseline_report(lens, BUDGETS, slots=2)
    wave_sim = T.replay_events(tengine.wave_baseline_events(lens, BUDGETS, slots=2),
                               T.LLAMA_1B, T.JETSON, T.CDPIM)
    for mode in ("hbcem", "lbim"):
        teng, _, jeng, _ = runs[mode]
        rep = teng.schedule_report()
        assert rep["decode_steps"] < wave["decode_steps"]
        assert rep["idle_slot_steps"] < wave["idle_slot_steps"]
        assert rep["decode_slot_steps"] < wave["decode_slot_steps"]
        sim = _same_price(teng, jeng, "llama-1b", "jetson-agx-orin-64gb", "cd-pim")
        assert sim.decode_busy_s < wave_sim.decode_busy_s


def test_replay_prices_lbim_no_worse_than_blocked(runs):
    """test_continuous_batching.py:126 on the port's events."""
    totals = {m: _same_price(runs[m][0], runs[m][2], "llama-1b", "jetson-agx-orin-64gb",
                             "cd-pim") for m in ("blocked", "lbim")}
    assert totals["lbim"].total_s <= totals["blocked"].total_s + 1e-9
    assert totals["lbim"].overlap_saved_s >= 0.0
    assert totals["lbim"].decode_busy_s > 0
    assert totals["lbim"].prefill_busy_s > 0


def test_replay_prices_skipped_prefill(runs):
    """test_cache_pool.py:252 on the port's events."""
    sims = {True: _same_price(runs["prefix_True"][0], runs["prefix_True"][2], "llama-1b",
                              "jetson-agx-orin-64gb", "cd-pim"),
            False: _price(runs["prefix_False"][0].events, "llama-1b", "jetson-agx-orin-64gb",
                          "cd-pim")}
    assert sims[True].reused_prefill_tokens > 0
    assert sims[True].prefix_saved_s > 0.0
    assert sims[True].prefill_busy_s < sims[False].prefill_busy_s
    assert sims[False].reused_prefill_tokens == 0
    assert sims[True].to_json()["prefix_saved_s"] == pytest.approx(sims[True].prefix_saved_s)


def test_slow_step_priced_as_stall(runs):
    """test_faults.py:153-160 on the port's events, with a slow step alone
    (the one-rung ladder has no retry to price): stall time, never cheaper
    than the fault-free twin."""
    clean = _same_price(runs["hbcem"][0], runs["hbcem"][2], "llama-1b",
                        "jetson-agx-orin-64gb", "cd-pim")
    teng, tres, jeng, _ = runs["hbcem_slow"]
    assert all(r.state is RequestState.FINISHED for r in tres)
    assert teng.fault_plan.fired() == 1
    sim = _same_price(teng, jeng, "llama-1b", "jetson-agx-orin-64gb", "cd-pim")
    assert sim.stall_s > 0 and sim.retried_attempts == 0
    assert sim.total_s > clean.total_s


def test_replay_report_json_roundtrips(runs):
    """test_serving_api.py:227 on the port's events."""
    teng, _, jeng, _ = runs["lbim"]
    sim = _same_price(teng, jeng, "llama-1b", "jetson-agx-orin-64gb", "cd-pim")
    payload = json.loads(json.dumps(sim.to_json()))
    assert payload["serialized_s"] == pytest.approx(sim.serialized_s)


@pytest.mark.parametrize("mname,dname", PRICES)
def test_priced_latency_equals_jax(runs, mname, dname):
    teng, tres, jeng, jres = runs["trace"]
    for kw in ({}, dict(ttft_slo_s=0.5, tpot_slo_s=0.2),
               dict(draft_model="llama-1b", ttft_slo_s=1e-3, tpot_slo_s=1e-3)):
        draft = kw.get("draft_model")
        t = ttraffic.priced_latency(teng.events, tres, T.MODELS[mname], T.DEVICES[dname],
                                    T.CDPIM, **{**kw, "draft_model": draft and T.MODELS[draft]})
        j = jtraffic.priced_latency(jeng.events, jres, J.MODELS[mname], J.DEVICES[dname],
                                    J.CDPIM, **{**kw, "draft_model": draft and J.MODELS[draft]})
        assert t == j


def test_priced_latency_replays_equal(runs):
    """test_traffic.py:150: the same events priced twice give equal dicts."""
    teng, tres, _, _ = runs["trace"]
    p1 = ttraffic.priced_latency(teng.events, tres, T.LLAMA_7B, T.JETSON, T.CDPIM,
                                 ttft_slo_s=0.5, tpot_slo_s=0.2)
    p2 = ttraffic.priced_latency(list(teng.events), tres, T.LLAMA_7B, T.JETSON, T.CDPIM,
                                 ttft_slo_s=0.5, tpot_slo_s=0.2)
    assert p1 == p2


def test_idle_events_price_at_zero(runs):
    """test_traffic.py:187: the replay's idle steps are the engine's."""
    teng, _, jeng, _ = runs["trace"]
    rep = teng.schedule_report()
    assert rep["idle_steps"] > 0
    sim = _same_price(teng, jeng, "llama-7b", "jetson-agx-orin-64gb", "cd-pim")
    assert sim.idle_steps == rep["idle_steps"]


def test_priced_latency_sections(runs):
    """test_traffic.py:272: percentiles in simulated seconds; every request
    attains when no second-domain SLO is set; a failed or unfinished request
    never attains."""
    teng, tres, _, _ = runs["trace"]
    p = ttraffic.priced_latency(teng.events, tres, T.LLAMA_7B, T.JETSON, T.CDPIM,
                                draft_model=T.LLAMA_1B)
    assert p["ttft_s"]["n"] == len(tres)
    assert p["ttft_s"]["p50"] > 0 and p["tpot_s"]["p50"] > 0
    assert p["slo"]["attainment"] == 1.0
    assert p["replay"] == T.replay_events(teng.events, T.LLAMA_7B, T.JETSON, T.CDPIM,
                                          draft_model=T.LLAMA_1B).to_json()
    failed = [dataclasses.replace(r, state=RequestState.FAILED) if i == 0 else r
              for i, r in enumerate(tres)]
    q = ttraffic.priced_latency(teng.events, failed, T.LLAMA_7B, T.JETSON, T.CDPIM)
    assert q["slo"]["met"] == len(tres) - 1

"""The port's ``Scheduler`` (``repro_torch.serve.scheduler``) against the JAX
package's, on the CPU: the contracts of ``tests/test_scheduler.py`` (the
queue-level mode pick, per-request budgets, eos, fused-step accounting,
``plan_step``), the bounded queue's ``AdmissionRejected`` and the two-phase
cancel, with drains equal to the JAX scheduler's at the llama3-8b f32 smoke
size.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import pim_modes as jpm  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.scheduler import Scheduler as JScheduler  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.pim_modes import Mode, SloAwarePolicy, plan_step  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.api import GenerationRequest, RequestState  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.errors import AdmissionRejected, ServingError  # noqa: E402
from repro_torch.serve.scheduler import Scheduler  # noqa: E402


@pytest.fixture(scope="module")
def models():
    jcfg = get_config("llama3-8b", smoke=True).replace(dtype="float32",
                                                        param_dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    yield jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jp, tp
    jax.clear_caches()


def _sched(models, **kw):
    _, tcfg, _, tp = models
    return Scheduler(Engine(tcfg, tp, max_len=64, slots=2, chunk=4), **kw)


def _jsched(models, **kw):
    jcfg, _, jp, _ = models
    return JScheduler(JEngine(jcfg, jp, max_len=64, slots=2, chunk=4), **kw)


def _results(sched):
    return {rid: (r.tokens, r.state.value, r.finish_reason, r.admit_step, r.first_token_step,
                  r.finish_step) for rid, r in sched.results.items()}


def test_auto_picks_lbim_for_prefill_heavy_queue(models):
    s = _sched(models)
    for _ in range(3):
        s.submit([1] * 12, max_new=2)   # long-in / short-out: compute-intensive
    assert s._pick_mode() is Mode.LBIM


def test_auto_picks_hbcem_for_decode_heavy_queue(models):
    s = _sched(models)
    for _ in range(3):
        s.submit([1, 2], max_new=12)    # short-in / long-out: memory-intensive
    assert s._pick_mode() is Mode.HBCEM


def test_explicit_mode_policy_overrides_queue_shape(models):
    s = _sched(models, mode_policy="blocked")
    s.submit([1] * 12, max_new=2)
    assert s._pick_mode() is Mode.BLOCKED


def test_auto_discounts_stored_prefix_blocks(models):
    """Prefix-store hits are prefill the engine will skip: after a drain
    stores the long shared prompt, the same queue tips to HBCEM."""
    s = _sched(models)
    prompt = list(range(1, 14))
    s.submit(prompt, max_new=6)
    assert s._pick_mode() is Mode.LBIM
    s.drain()
    s.submit(prompt, max_new=6)
    assert s._pick_mode() is Mode.HBCEM


@pytest.mark.parametrize("policy", ["auto", "hbcem"])
def test_drain_honors_per_request_max_new_and_equals_jax(models, policy):
    s, js = _sched(models, mode_policy=policy), _jsched(models, mode_policy=policy)
    budgets = {}
    for mn in (1, 6, 2, 4):
        budgets[s.submit([1, 2, 3], max_new=mn)] = mn
        js.submit([1, 2, 3], max_new=mn)
    res, jres = s.drain(), js.drain()
    assert res == jres
    assert {rid: len(toks) for rid, toks in res.items()} == budgets
    assert _results(s) == _results(js)
    rep = s.engine.schedule_report()
    assert rep["decode_slot_steps"] == sum(mn - 1 for mn in budgets.values())
    assert rep["mode_steps"] == js.engine.schedule_report()["mode_steps"]
    assert isinstance(s.engine.step_policy, SloAwarePolicy) == (policy == "auto")


def test_drain_clears_queue_and_empty_drain(models):
    s = _sched(models)
    assert s.drain() == {}
    s.submit([1, 2], max_new=2)
    s.drain()
    assert s.queue == [] and s.drain() == {}


def test_drain_passes_eos_to_engine(models):
    s = _sched(models, mode_policy="hbcem")
    rid = s.submit([1, 2, 3], max_new=8)
    ref = s.drain()[rid]
    eos = ref[2]
    rid2 = s.submit([1, 2, 3], max_new=8)
    out = s.drain(eos_id=eos)[rid2]
    assert out == ref[: ref.index(eos) + 1]
    assert s.results[rid2].finish_reason == "eos"


def test_schedule_report_fused_step_counting(models):
    _, tcfg, _, tp = models
    eng = Engine(tcfg, tp, max_len=64, slots=2, mode=Mode.LBIM, chunk=4)
    eng.serve([GenerationRequest(prompt=[1, 2, 3, 4], max_new_tokens=6) for _ in range(4)])
    rep = eng.schedule_report()
    fused = [e for e in eng.events if e.plan.fused]
    assert rep["fused_steps"] == len(fused) > 0
    for e in fused:
        assert e.plan.label == "MACT_LDB" and e.decode_batch > 0 and e.prefill_tokens > 0
    assert rep["steps"] == len(eng.events)
    assert rep["prefill_tokens"] == 16


def test_plan_step_equals_jax():
    for mode in Mode:
        for dec, pre, spec in ((True, True, False), (True, True, True), (True, False, False),
                               (True, False, True), (False, True, False),
                               (False, False, False)):
            ours = plan_step(mode, dec, pre, 8 if pre else 0, spec=spec)
            theirs = jpm.plan_step(jpm.Mode(mode.value), dec, pre, 8 if pre else 0, spec=spec)
            assert dataclasses.astuple(ours) == dataclasses.astuple(theirs)
            assert ours.label == theirs.label
    both = dict(have_decodes=True, have_prefills=True, chunk=8)
    assert plan_step(Mode.LBIM, **both).fused
    assert plan_step(Mode.HBCEM, **both).label == "split"
    assert not plan_step(Mode.BLOCKED, **both).decode


def test_bounded_queue_rejects_on_full(models):
    s = _sched(models, max_queue=2)
    s.submit([1, 2], max_new=2)
    s.submit([3, 4], max_new=2)
    with pytest.raises(AdmissionRejected) as ei:
        s.submit([5, 6], max_new=2)
    assert isinstance(ei.value, ServingError)
    assert ei.value.depth == 2 and ei.value.max_queue == 2
    assert "admission queue full (2/2)" in str(ei.value)
    # shedding one queued request reopens the front door
    assert s.cancel(0)
    assert s.results[0].state is RequestState.CANCELLED
    assert s.results[0].finish_reason == "cancelled"
    rid = s.submit([5, 6], max_new=2)
    out = s.drain()
    assert 0 not in out and rid in out
    assert not s.cancel(rid) and not s.cancel(99)   # done / unknown


def test_cancel_inside_a_running_drain_equals_jax(models):
    """Phase two of cancel: a request inside a running drain is forwarded to
    ``Engine.cancel`` from an ``on_token`` callback and honored at the next
    step boundary, with its emitted tokens kept."""
    out = {}
    for name, make in (("port", _sched), ("jax", _jsched)):
        s = make(models, mode_policy="lbim")
        seen = []
        rids = [s.submit([1, 2, 3], max_new=4)]
        rids.append(s.submit([4, 5, 6, 7], max_new=8,
                             on_token=lambda t, s=s, seen=seen: (
                                 seen.append(t), len(seen) == 2 and s.cancel(rids[1]))))
        rids.append(s.submit([8, 9], max_new=3))
        s.drain()
        out[name] = (_results(s), s.engine.health()["counters"])
    assert out["port"] == out["jax"]
    res, counters = out["port"]
    assert res[1][1] == "cancelled" and len(res[1][0]) >= 2
    assert res[0][1] == res[2][1] == "finished"
    assert counters["cancellations"] == 1

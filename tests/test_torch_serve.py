"""The port's serving slice as a whole against the JAX package, on the CPU.

``Engine.serve`` of both packages runs the canonical ragged request set
(``serving_refs.PROMPTS``/``BUDGETS``) at an f32 smoke size, through
BLOCKED/HBCEM/LBIM x W8A8 decode off/on x KV splits 1/2. Tokens, finish
reasons, states, latency marks and the ``ScheduleEvent`` fields the port
carries must be equal. Then the port's guard rails: the device rule, and the
request features that once were refused, each served as the JAX engine
serves it.
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
from repro.serve.serving_model import ServingModel as JServing  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core.pim_modes import Mode  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.api import GenerationRequest, RequestState, SamplingParams  # noqa: E402
from repro_torch.serve.cache import CachePool  # noqa: E402
from repro_torch.serve.serving_model import ServingModel  # noqa: E402
from serving_refs import BUDGETS, MAX_LEN, PROMPTS  # noqa: E402

MODES = ["BLOCKED", "HBCEM", "LBIM"]
# prompts 0 and 4 share a two-block (chunk 4) prefix with prompt 1's head
PREFIX_PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3], [7, 7], [3, 1, 4, 1, 5, 9, 2, 6, 8],
                  [2, 7, 1], [3, 1, 4, 1, 5, 9, 2, 6, 1, 1, 2]]
PREFIX_BUDGETS = [4, 6, 3, 2, 5]


@pytest.fixture(scope="module")
def models():
    jcfg = get_config("llama3-8b", smoke=True).replace(dtype="float32",
                                                        param_dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jp, tp


def event_fields(ev):
    return (ev.plan.label, ev.plan.decode, ev.plan.prefill_chunk, ev.plan.fused,
            ev.decode_batch, ev.prefill_tokens, ev.decode_ctx, ev.reused_tokens,
            ev.kv_splits, ev.mode, ev.arrivals, ev.queue_depth, ev.emitted_tokens,
            ev.first_tokens)


def result_fields(r):
    return (r.tokens, r.finish_reason, r.state.value, r.prompt_len,
            r.reused_prefix_tokens, r.admit_step, r.first_token_step, r.finish_step)


REPORT_KEYS = ("steps", "fused_steps", "modes", "mode_steps", "decode_steps",
               "decode_slot_steps", "idle_slot_steps", "prefill_tokens",
               "reused_prefix_tokens", "arrivals", "prefix")


def run_jax(jcfg, jp, mode, prompts, budgets, eos=None, quantized=False, splits=1):
    cfg = jcfg.replace(quantized_decode=quantized, decode_kv_splits=splits)
    eng = JServing.prepare(cfg, jp, max_len=MAX_LEN, slots=2).engine(mode=JMode[mode],
                                                                      chunk=4)
    res = eng.serve([JReq(prompt=p, max_new_tokens=b, eos_id=eos)
                     for p, b in zip(prompts, budgets)])
    rep = eng.schedule_report()
    return ([result_fields(r) for r in res], [event_fields(e) for e in eng.events],
            {k: rep[k] for k in REPORT_KEYS})


def run_torch(tcfg, tp, mode, prompts, budgets, eos=None, quantized=False, splits=1):
    cfg = tcfg.replace(quantized_decode=quantized, decode_kv_splits=splits)
    sm = ServingModel.prepare(cfg, tp, max_len=MAX_LEN, slots=2, device="cpu")
    eng = sm.engine(mode=Mode[mode], chunk=4)
    res = eng.serve([GenerationRequest(prompt=p, max_new_tokens=b, eos_id=eos)
                     for p, b in zip(prompts, budgets)])
    assert eng.pool.check_invariants() == []
    rep = eng.schedule_report()
    return ([result_fields(r) for r in res], [event_fields(e) for e in eng.events],
            {k: rep[k] for k in REPORT_KEYS})


@pytest.fixture(scope="module")
def jax_runs(models):
    jcfg, _, jp, _ = models
    return {(m, q, s): run_jax(jcfg, jp, m, PROMPTS, BUDGETS, quantized=q, splits=s)
            for m in MODES for q in (False, True) for s in (1, 2)}


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_engine_serve_matches_jax(models, jax_runs, mode, quantized, splits):
    _, tcfg, _, tp = models
    jres, jev, jrep = jax_runs[(mode, quantized, splits)]
    tres, tev, trep = run_torch(tcfg, tp, mode, PROMPTS, BUDGETS, quantized=quantized,
                                splits=splits)
    assert tres == jres
    assert tev == jev
    assert trep == jrep
    assert all(r[2] == "finished" for r in tres)


@pytest.mark.parametrize("mode", MODES)
def test_prefix_reuse_matches_jax(models, mode):
    jcfg, tcfg, jp, tp = models
    jres, jev, jrep = run_jax(jcfg, jp, mode, PREFIX_PROMPTS, PREFIX_BUDGETS)
    tres, tev, trep = run_torch(tcfg, tp, mode, PREFIX_PROMPTS, PREFIX_BUDGETS)
    assert trep["reused_prefix_tokens"] > 0
    assert (tres, tev, trep) == (jres, jev, jrep)


def test_eos_retirement_matches_jax(models, jax_runs):
    jcfg, tcfg, jp, tp = models
    eos = jax_runs[("HBCEM", False, 1)][0][1][0][3]   # a token emitted mid-stream
    jres, jev, _ = run_jax(jcfg, jp, "LBIM", PROMPTS, BUDGETS, eos=eos)
    tres, tev, _ = run_torch(tcfg, tp, "LBIM", PROMPTS, BUDGETS, eos=eos)
    assert tres == jres and tev == jev
    assert any(r[1] == "eos" for r in tres)


def test_serve_twice_on_one_engine_keeps_prefix_store(models):
    _, tcfg, _, tp = models
    eng = ServingModel.prepare(tcfg, tp, max_len=MAX_LEN, slots=2, device="cpu").engine(
        mode=Mode.LBIM, chunk=4)
    reqs = [GenerationRequest(prompt=p, max_new_tokens=b)
            for p, b in zip(PREFIX_PROMPTS, PREFIX_BUDGETS)]
    first = [r.tokens for r in eng.serve(reqs)]
    second = eng.serve(reqs)
    assert [r.tokens for r in second] == first
    assert eng.schedule_report()["reused_prefix_tokens"] > 0
    assert eng.pool.check_invariants() == []


# --------------------------------------------------------------------------
# guard rails
# --------------------------------------------------------------------------


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(models, monkeypatch):
    _, tcfg, _, tp = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingModel.prepare(tcfg, tp, max_len=MAX_LEN)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CachePool(tcfg, MAX_LEN, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.params_from_numpy({"embed": {"w": np.zeros((2, 2), np.float32)}})
    assert ServingModel.prepare(tcfg, tp, max_len=MAX_LEN, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("field,value,roadmap", [
    ("sampling", SamplingParams(temperature=0.7), "A.1"),
    ("priority", 1, "A.3"),
    ("ttft_deadline", 5, "A.4"),
    ("deadline", 9, "A.4"),
    ("arrival_step", 2, "A.4"),
    ("spec_k", 2, "A.5"),
])
def test_unported_request_features_raise(models, field, value, roadmap):
    """Every request feature that once raised (citing its ROADMAP item) is
    ported now. Sampled decoding (A.1) and ``spec_k`` (A.5, ignored without a
    draft model, as in the JAX engine) are served to the end; a priority
    (A.3), a deadline or an arrival step (A.4) is served to the terminal
    state, tokens and latency marks the JAX engine gives the same request."""
    jcfg, tcfg, jp, tp = models
    eng = ServingModel.prepare(tcfg, tp, max_len=MAX_LEN, slots=2, device="cpu").engine()
    req = GenerationRequest(prompt=[1, 2, 3], max_new_tokens=2, **{field: value})
    res = eng.serve([req])[0]
    if roadmap in ("A.1", "A.5"):
        assert res.state is RequestState.FINISHED and len(res.tokens) == 2
        return
    jeng = JServing.prepare(jcfg, jp, max_len=MAX_LEN, slots=2).engine()
    jres = jeng.serve([JReq(prompt=[1, 2, 3], max_new_tokens=2, **{field: value})])[0]
    assert res.state.value == jres.state.value == "finished"
    assert result_fields(res) == result_fields(jres)
    assert res.arrival_step == jres.arrival_step == req.arrival_step
    assert eng.pool.check_invariants() == []


def test_backend_names(models):
    _, tcfg, _, _ = models
    assert dispatch.resolve_backend(tcfg, "cpu") == "reference"
    assert dispatch.resolve_backend(tcfg, "cuda") == "kernel"
    assert dispatch.resolve_backend(tcfg.replace(attn_backend="reference"), "cpu") == \
        "reference"
    for bad in ("pallas", "interpret", "dense", "nonsense"):
        with pytest.raises(ValueError):
            dispatch.resolve_backend(tcfg.replace(attn_backend=bad), "cpu")
    with pytest.raises(ValueError, match="CPU-only"):
        dispatch.resolve_backend(tcfg.replace(attn_backend="reference"), "cuda")


def test_pool_accounting_through_a_serve(models):
    _, tcfg, _, tp = models
    eng = ServingModel.prepare(tcfg, tp, max_len=MAX_LEN, slots=2, device="cpu").engine(
        mode=Mode.HBCEM, chunk=4)
    res = eng.serve([GenerationRequest(prompt=p, max_new_tokens=b)
                     for p, b in zip(PROMPTS, BUDGETS)])
    assert all(r.state is RequestState.FINISHED for r in res)
    occ = eng.pool.occupancy()
    assert occ.slots_used == 0 and eng.pool.check_invariants() == []
    assert eng.schedule_report().to_json()["modes"] == sorted(eng.schedule_report()["modes"])

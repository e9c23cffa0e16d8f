"""The port's engine serving the MoE family against the JAX engine, on the CPU
at f32 smoke sizes and at the configs' own capacity factor (2.0).

A MoE token's output depends on the tokens that share its forward: picks
past an expert's capacity drop. So the port groups tokens exactly as the JAX
engine does: one ragged prefill per batch-admission group (pads included),
one forward per admission chunk, and every lane of a decode step, free lanes
fed the tokens the JAX engine feeds them. Four lanes, so an olmoe-smoke decode
step has capacity 2 of 4 and picks drop; tokens, request states, latency
marks and ``ScheduleEvent``s equal the JAX engine's in BLOCKED, HBCEM and
LBIM at KV splits 1 and 2, with a ragged batch admission, prefix reuse on and
off, and a preemption resume. A speculative engine with an MoE target (a
self-draft) equals the JAX spec engine: its verify feeds the drafting lanes'
candidates and 0 on the others, so it is held to the JAX spec engine's tokens,
not to plain decode's.
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
from repro.serve.spec import SpecConfig as JSpec  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.pim_modes import Mode  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoe  # noqa: E402
from repro_torch.serve.api import GenerationRequest  # noqa: E402
from repro_torch.serve.serving_model import ServingModel  # noqa: E402
from repro_torch.serve.spec import SpecConfig  # noqa: E402
from test_torch_gemma2 import _requests, result_fields  # noqa: E402
from test_torch_spec import _events as spec_event_fields  # noqa: E402
from test_torch_serve import PREFIX_BUDGETS, PREFIX_PROMPTS, REPORT_KEYS, event_fields  # noqa: E402,E501

ARCHS = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]
MODES = ["BLOCKED", "HBCEM", "LBIM"]
SLOTS, CHUNK, MAX_LEN = 4, 4, 32
# six ragged prompts over four lanes: a ragged batch admission (its three
# short rows padded to 17 with token 0, whose picks pile onto the same
# experts and take their capacity), then staged admission while lanes
# decode; prompt 4 repeats one token, so the picks of its chunks pile up too
PROMPTS = [[(5 * i + 3 * j) % 250 + 1 for j in range(n)]
           for i, n in enumerate((17, 3, 4, 6, 17, 9))]
PROMPTS[4] = [7] * 17
BUDGETS = [5, 7, 3, 6, 4, 8]


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg = get_config(request.param, smoke=True).replace(dtype="float32",
                                                         param_dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jp, tp


def run_jax(jcfg, jp, mode, splits=1, prefix_cache=True, **kw):
    eng = JServing.prepare(jcfg.replace(decode_kv_splits=splits), jp, max_len=MAX_LEN,
                           slots=SLOTS).engine(mode=JMode[mode], chunk=CHUNK,
                                               prefix_cache=prefix_cache)
    res = eng.serve(_requests(JReq, **kw))
    rep = eng.schedule_report()
    return ([result_fields(r) for r in res], [event_fields(e) for e in eng.events],
            {k: rep[k] for k in REPORT_KEYS})


def run_torch(tcfg, tp, mode, splits=1, prefix_cache=True, **kw):
    eng = ServingModel.prepare(tcfg.replace(decode_kv_splits=splits), tp, max_len=MAX_LEN,
                               slots=SLOTS, device="cpu").engine(
        mode=Mode[mode], chunk=CHUNK, prefix_cache=prefix_cache)
    assert eng.pool.paged
    res = eng.serve(_requests(GenerationRequest, **kw))
    assert eng.pool.check_invariants() == []
    rep = eng.schedule_report()
    return ([result_fields(r) for r in res], [event_fields(e) for e in eng.events],
            {k: rep[k] for k in REPORT_KEYS})


@pytest.fixture
def moe_calls(monkeypatch):
    """Every ``moe_einsum`` call of the port: (input shape, picks dropped)."""
    calls = []
    moe = TMoe.moe_einsum

    def spy(p, x, cfg):
        n_groups, sg, cap = TMoe.capacity(x.reshape(-1, x.shape[-1]).shape[0], cfg)
        _, idx, _ = TMoe._router(p, x.reshape(-1, x.shape[-1]), cfg)
        _, keep = TMoe.keep_rule(idx.reshape(n_groups, sg, cfg.top_k), cfg.n_experts, cap)
        calls.append((tuple(x.shape[:2]), int((~keep).sum())))
        return moe(p, x, cfg)

    monkeypatch.setattr(TMoe, "moe_einsum", spy)
    return calls


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_engine_serve_matches_jax(models, moe_calls, mode, splits):
    jcfg, tcfg, jp, tp = models
    kw = dict(prompts=PROMPTS, budgets=BUDGETS)
    jres, jev, jrep = run_jax(jcfg, jp, mode, splits, **kw)
    tres, tev, trep = run_torch(tcfg, tp, mode, splits, **kw)
    assert tres == jres
    assert tev == jev
    assert trep == jrep
    assert all(r[2] == "finished" for r in tres)
    # the first event is one ragged batch admission of four requests
    assert jev[0][5] == sum(len(p) for p in PROMPTS[:SLOTS])
    decode_drops = sum(d for (b, tt), d in moe_calls if tt == 1 and b == SLOTS)
    admit_drops = sum(d for (b, tt), d in moe_calls if tt > 1 and b == SLOTS)
    if tcfg.n_experts == 8:   # olmoe-smoke: capacity 2 of 4 lanes, 34 of the 68 tokens
        assert decode_drops > 0 and admit_drops > 0   # the padded admission drops too
    else:                     # phi3.5-smoke: capacity equals the tokens of every call
        assert decode_drops == admit_drops == 0


def test_hbcem_chunks_drop_picks(models, moe_calls):
    """One HBCEM serve whose admission chunks drop picks (olmoe-smoke: a chunk
    of 8 tokens has capacity 4); phi3.5-smoke's chunks cannot (capacity 8).
    A chunk is one forward, never cut into ``chunk``-token sub-steps. Tokens
    and events equal the JAX engine's all the same."""
    jcfg, tcfg, jp, tp = models
    kw = dict(prompts=PROMPTS, budgets=BUDGETS)
    assert run_torch(tcfg, tp, "HBCEM", **kw) == run_jax(jcfg, jp, "HBCEM", **kw)
    chunks = [(tt, d) for (b, tt), d in moe_calls if b == 1 and tt > 1]
    assert any(tt > CHUNK for tt, _ in chunks)    # a boosted chunk is one call, uncut
    if tcfg.n_experts == 8:
        assert sum(d for _, d in chunks) > 0
    else:
        assert sum(d for _, d in chunks) == 0


@pytest.mark.parametrize("mode,prefix_cache", [("BLOCKED", True), ("HBCEM", True),
                                               ("LBIM", True), ("HBCEM", False)])
def test_prefix_reuse_matches_jax(models, mode, prefix_cache):
    """Prompts 0 and 4 share a two-block prefix: prompt 4 maps prompt 0's
    pages (its chunk stream starts past them) with the prefix store on, and
    prefills them anew with it off; both as the JAX engine does."""
    jcfg, tcfg, jp, tp = models
    kw = dict(prompts=PREFIX_PROMPTS, budgets=PREFIX_BUDGETS)
    jres, jev, jrep = run_jax(jcfg, jp, mode, prefix_cache=prefix_cache, **kw)
    tres, tev, trep = run_torch(tcfg, tp, mode, prefix_cache=prefix_cache, **kw)
    assert (trep["reused_prefix_tokens"] > 0) == prefix_cache
    assert (tres, tev, trep) == (jres, jev, jrep)


def test_preemption_resume_matches_jax(models):
    """A priority-1 request arriving while every lane decodes preempts the
    lowest-priority lane; the victim re-admits prompt + emitted tokens through
    the chunk stream and resumes. Tokens, states, preemption counts and
    events equal the JAX engine's."""
    jcfg, tcfg, jp, tp = models
    kw = dict(prompts=[PROMPTS[i] for i in (0, 2, 3, 5, 1)], budgets=[12, 12, 12, 12, 3],
              prio=[0, 0, 0, 0, 1], arrival=[0, 0, 0, 0, 3])
    jres, jev, jrep = run_jax(jcfg, jp, "HBCEM", **kw)
    tres, tev, trep = run_torch(tcfg, tp, "HBCEM", **kw)
    assert (tres, tev, trep) == (jres, jev, jrep)
    assert sum(r[4] for r in tres) >= 1 and all(r[2] == "finished" for r in tres)


@pytest.mark.parametrize("mode", MODES)
def test_spec_self_draft_matches_jax(models, moe_calls, mode):
    """The MoE target drafting for itself (k 3): tokens, states, spec events
    and the spec report equal the JAX spec engine's. Verify scores each span
    position as a four-lane one-token step (0 fed on lanes with no candidate
    there), so on olmoe-smoke (capacity 2 of 4) those steps drop picks."""
    jcfg, tcfg, jp, tp = models
    kw = dict(prompts=PROMPTS, budgets=BUDGETS)
    jsm = JServing.prepare(jcfg, jp, max_len=MAX_LEN, slots=SLOTS)
    jeng = jsm.engine(mode=JMode[mode], chunk=CHUNK, spec=JSpec(draft=jsm, k=3))
    jres = jeng.serve(_requests(JReq, **kw))
    tsm = ServingModel.prepare(tcfg, tp, max_len=MAX_LEN, slots=SLOTS, device="cpu")
    teng = tsm.engine(mode=Mode[mode], chunk=CHUNK, spec=SpecConfig(draft=tsm, k=3))
    tres = teng.serve(_requests(GenerationRequest, **kw))
    assert [result_fields(r) for r in tres] == [result_fields(r) for r in jres]
    assert spec_event_fields(teng) == spec_event_fields(jeng)
    rep = teng.schedule_report()["spec"]
    assert rep == jeng.schedule_report()["spec"]
    assert rep["rounds"] >= 1 and all(r.state.value == "finished" for r in tres)
    assert teng.pool.check_invariants() == [] == teng.spec_dec.pool.check_invariants()
    step_drops = sum(d for (b, tt), d in moe_calls if b == SLOTS and tt == 1)
    assert step_drops > 0 if tcfg.n_experts == 8 else step_drops == 0

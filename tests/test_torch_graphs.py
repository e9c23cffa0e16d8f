"""The captured step programs' host side, on the CPU: ``core.interleave``'s
graph keys and ``eager()``, the pool's persistent step inputs (block tables,
fills, contiguous staging lanes) against freshly built ones and against the
JAX pool, the host-side fills against the device's, and the spec verify's
copies of a graph's static logits. No graph is captured here (there is no
card): ``tests/test_torch_cuda.py`` holds captured serves to eager ones.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.pim_modes import Mode as JMode  # noqa: E402
from repro.serve import cache as jcache  # noqa: E402
from repro.serve.api import GenerationRequest as JReq  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.serving_model import ServingModel as JServing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import interleave  # noqa: E402
from repro_torch.core.pim_modes import Mode  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.api import GenerationRequest  # noqa: E402
from repro_torch.serve.cache import DUMMY_PAGE, CachePool  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.serving_model import ServingModel  # noqa: E402
from repro_torch.serve.spec import SpecConfig  # noqa: E402
from serving_refs import BUDGETS, MAX_LEN, PROMPTS  # noqa: E402

MODES = ["BLOCKED", "HBCEM", "LBIM"]


@pytest.fixture(scope="module")
def smoke():
    """llama3-8b smoke, W8A8, seeded torch weights (no JAX here)."""
    cfg = get_config("llama3-8b", smoke=True).replace(quantized_decode=True)
    return cfg, TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def requests():
    return [GenerationRequest(prompt=p, max_new_tokens=b) for p, b in zip(PROMPTS, BUDGETS)]


# --------------------------------------------------------------------------
# the graph key and eager()
# --------------------------------------------------------------------------


def test_graph_key_follows_shapes_statics_and_addresses(smoke):
    cfg, _ = smoke
    g = interleave.StepGraphs("cpu")
    params = {"w": torch.zeros(3)}
    cache = {"k_pages": torch.zeros(2, 3), "block_table": torch.zeros(4, 5, dtype=torch.int32),
             "pos": torch.zeros(4, dtype=torch.int32)}
    tok = torch.zeros(4, 1, dtype=torch.int64)
    key = g.key("decode_only", params, (cache,), (tok,), cfg)
    # the same tensors (another dict), other token values at another address
    assert key == g.key("decode_only", params, (dict(cache),), (torch.ones(4, 1).long(),), cfg)
    wide = {**cache, "block_table": torch.zeros(8, 5, dtype=torch.int32),
            "pos": torch.zeros(8, dtype=torch.int32)}
    others = [
        g.key("decode_only", params, (wide,), (torch.zeros(8, 1).long(),), cfg),   # width
        g.key("decode_only", params, (cache,), (torch.zeros(4, 2).long(),), cfg),  # T
        g.key("prefill_chunk", params, (cache,), (tok,), cfg, (True,)),            # gemm
        g.key("prefill_chunk", params, (cache,), (tok,), cfg, (False,)),
        g.key("decode_only", params, (cache,), (tok,), cfg.replace(decode_kv_splits=2)),
        g.key("decode_only", params, ({**cache, "pos": cache["pos"].clone()},), (tok,), cfg),
        g.key("decode_only", {"w": torch.zeros(3)}, (cache,), (tok,), cfg),        # params
        g.key("decode_only", params, (cache,), (tok.int(),), cfg),                 # dtype
    ]
    assert len({key, *others}) == len(others) + 1


def test_eager_nests_and_restores():
    assert interleave.capture_enabled()
    with interleave.eager():
        assert not interleave.capture_enabled()
        with interleave.eager():
            assert not interleave.capture_enabled()
        assert not interleave.capture_enabled()
    assert interleave.capture_enabled()
    with pytest.raises(ValueError):
        with interleave.eager():
            raise ValueError("inside")
    assert interleave.capture_enabled()


def planted_sync():
    raise RuntimeError("operation not permitted when stream is capturing")


def test_capture_error_names_the_frame_that_broke_it():
    """What a failed capture reports: the innermost frame outside torch, also
    when the capture's end raised again while the first error propagated."""
    try:
        try:
            planted_sync()
        except RuntimeError:
            raise RuntimeError("capture invalidated")
    except RuntimeError as e:
        where = interleave._where(e)
    assert "test_torch_graphs.py" in where and "planted_sync" in where


def test_add_launches_adds_and_takes_back():
    from repro_torch.kernels import add_launches, launch_counts, reset_launches

    reset_launches()
    add_launches({"pim_gemv": 7, "merge_splits": 2})
    add_launches({"pim_gemv": -3})
    counts = launch_counts()
    assert counts["pim_gemv"] == 4 and counts["merge_splits"] == 2
    reset_launches()


# --------------------------------------------------------------------------
# the pool's persistent step inputs
# --------------------------------------------------------------------------


def spied_serve(cfg, params, mode, *, paged=True, spec=False):
    """One CPU serve whose pool and step programs are checked at every step:
    ``views()`` hands out the same tensors with the freshly built table and
    fill; after every decode step the host fills equal the device's, after
    every chunk the stream's host fill equals its ``pos``. Returns the
    results and the checks' tallies."""
    sm = ServingModel.prepare(cfg, params, max_len=MAX_LEN, slots=2, device="cpu")
    pool = sm.cache_pool(slots=2, prefix_cache=False, block_size=4, paged=paged,
                         spec_slack=3 if spec else 0)
    eng = Engine(cfg, params, max_len=MAX_LEN, slots=2, mode=Mode[mode], chunk=4,
                 serving=sm, prefix_cache=False, pool=pool,
                 spec=SpecConfig(draft=sm, k=3) if spec else None)
    seen = {"views": [], "commits": 0, "chunks": 0}
    real_views, real_commit = pool.views, pool.commit

    def views(span=1):
        out = real_views(span)
        if pool.paged:
            bt = pool._kv.block_tables
            assert np.array_equal(out["block_table"].numpy(),
                                  np.where(bt >= 0, bt, DUMMY_PAGE))
        assert np.array_equal(out["pos"].numpy(), pool._pos)
        seen["views"].append(tuple(id(out[k]) for k in sorted(out)))
        return out

    def commit(new_cache):
        device = new_cache["pos"].numpy().copy()
        real_commit(new_cache)
        act = pool.active_slots()
        assert (device[act] == pool._pos[act]).all()
        seen["commits"] += 1

    def staging_fill(cache):
        if pool.paged:
            return pool._kv.staging.fill
        [j] = [j for j, st in enumerate(pool._stagings) if st["pos"] is cache["pos"]]
        return pool._staging_fills[j]

    def checked(fn, at):
        def run(*a, **kw):
            out = fn(*a, **kw)
            cache = out[at]
            assert int(cache["pos"].reshape(-1)[0]) == staging_fill(cache)
            seen["chunks"] += 1
            return out
        return run

    pool.views, pool.commit = views, commit
    eng.graphs.prefill_chunk_step = checked(eng.graphs.prefill_chunk_step, 1)
    eng.graphs.fused_step = checked(eng.graphs.fused_step, 3)
    res = eng.serve(requests())
    assert pool.check_invariants() == []
    return res, eng, seen


@pytest.mark.parametrize("mode", MODES)
def test_views_hand_out_persistent_buffers(smoke, mode):
    cfg, params = smoke
    res, eng, seen = spied_serve(cfg, params, mode)
    assert [len(r.tokens) for r in res] == BUDGETS
    assert len(set(seen["views"])) == 1 and len(seen["views"]) > 5
    assert seen["commits"] == len(seen["views"]) > 0 and seen["chunks"] > 0
    st = eng.graphs.stats()
    # on the CPU every step program runs eagerly; nothing is captured
    assert st["eager_steps"] > 0 and st["captures"] == st["replays"] == st["graphs"] == 0


def test_verify_positions_commit_host_fills(smoke):
    """A spec serve: every verify position's view and commit."""
    cfg, params = smoke
    res, eng, seen = spied_serve(cfg, params, "HBCEM", spec=True)
    assert eng.schedule_report()["spec"]["rounds"] > 0
    assert len(set(seen["views"])) == 1 and seen["commits"] > len(BUDGETS)


def test_views_and_fills_equal_the_jax_pools():
    """The port's pool and the JAX pool driven through the engine's protocol
    (a chunked admission, a prefix hit, decode steps, a retire): the same
    block tables and fills at every view; the port's in the same tensors."""
    jcfg = jget_config("llama3-8b", smoke=True)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jcache.CachePool(jcfg, 32, 2, prefix_cache=True, block_size=4)
    tp = CachePool(tcfg, 32, 2, prefix_cache=True, block_size=4, device="cpu")
    first = {}

    def same(tv, jv, what):
        for k in ("block_table", "pos"):
            assert np.array_equal(tv[k].numpy(), np.asarray(jv[k])), (what, k)
            assert first.setdefault((what, k), tv[k]) is tv[k], (what, k)

    def admit(prompt, rid, chunks):
        tc, tskip = tp.stage_admission(prompt)
        jc, jskip = jp.stage_admission(prompt)
        assert tskip == jskip
        for n in chunks:
            tc, jc = tp.staging_step_prep(tc, n), jp.staging_step_prep(jc, n)
            same(tc, jc, "staging")
            tc["pos"] += n                                # the step, in place
            jc = {**jc, "pos": jc["pos"] + n}
        req = GenerationRequest(prompt=prompt, max_new_tokens=4)
        si = tp.alloc(req, rid, reused_tokens=tskip)
        assert si == jp.alloc(JReq(prompt=prompt, max_new_tokens=4), rid, reused_tokens=jskip)
        tp.insert(si, tc, prompt=prompt)
        jp.insert(si, jc, prompt=prompt)
        return tskip

    def decode(n):
        for _ in range(n):
            tv, jv = tp.views(), jp.views()
            same(tv, jv, "views")
            tv["pos"] += 1                                # the step, in place
            tp.commit(tv)
            jp.commit({**jv, "pos": jv["pos"] + 1})

    a = list(range(1, 11))
    assert admit(a, 0, [4, 4, 2]) == 0
    decode(3)
    assert admit(a[:8] + [20, 21, 22], 1, [3]) == 8      # two shared blocks
    decode(2)
    tp.retire(0)
    jp.retire(0)
    decode(2)
    assert tp.check_invariants() == [] and jp.check_invariants() == []
    assert (tp._kv.refcount == jp._kv.refcount).all()


def test_persistent_staging_is_reset_between_admissions():
    """A contiguous pool's staging caches are the same tensors every
    admission, zeroed (a recurrent state too) and at fill 0."""
    cfg = get_config("zamba2-7b", smoke=True)
    pool = CachePool(cfg, 16, 2, device="cpu")
    a, _ = pool.stage_admission([1, 2, 3])
    for leaf in a.values():
        leaf.fill_(3)
    a = pool.staging_step_prep(a, 3)
    assert int(a["pos"][0]) == 0 and pool._staging_fills[0] == 3
    b, _ = pool.stage_admission([4, 5])
    assert all(b[k] is a[k] for k in a)
    assert all(not leaf.any() for leaf in b.values())
    c = pool.begin_batch_admission(1)                      # a group's second request
    assert all(c[k] is not a[k] for k in a) and all(not leaf.any() for leaf in c.values())


# two batch-admitted requests, then two streamed through the one staging cache
# while the others decode (LBIM fuses their chunks); whole chunks only, so the
# JAX engine compiles few programs
STAGED_PROMPTS = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 1, 2, 3, 4, 5, 6, 7], [2, 7, 1, 8]]
STAGED_BUDGETS = [3, 5, 2, 3]


def test_persistent_staging_gives_the_jax_engines_tokens():
    """Contiguous LBIM at f32 smoke size: every streamed admission reuses the
    staging lanes (reset in place); the tokens equal the JAX engine's on the
    same weights (the port's seeded tree, stacked for JAX)."""
    tcfg = get_config("llama3-8b", smoke=True).replace(dtype="float32",
                                                       param_dtype="float32")
    jcfg = jget_config("llama3-8b", smoke=True).replace(dtype="float32",
                                                        param_dtype="float32")
    tparams = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, TM.params_to_numpy(tparams))
    jsm = JServing.prepare(jcfg, jparams, max_len=MAX_LEN, slots=2)
    jeng = JEngine(jsm.cfg, jparams, max_len=MAX_LEN, slots=2, mode=JMode.LBIM, chunk=4,
                   serving=jsm, prefix_cache=False,
                   pool=jsm.cache_pool(slots=2, prefix_cache=False, block_size=4,
                                       paged=False))
    want = [r.tokens for r in jeng.serve([JReq(prompt=p, max_new_tokens=b)
                                          for p, b in zip(STAGED_PROMPTS, STAGED_BUDGETS)])]
    sm = ServingModel.prepare(tcfg, tparams, max_len=MAX_LEN, slots=2, device="cpu")
    pool = sm.cache_pool(slots=2, prefix_cache=False, block_size=4, paged=False)
    eng = Engine(tcfg, tparams, max_len=MAX_LEN, slots=2, mode=Mode.LBIM, chunk=4,
                 serving=sm, prefix_cache=False, pool=pool)
    handed = []
    real = pool.init_staging

    def init_staging(index=0):
        out = real(index)
        assert all(not leaf.any() for leaf in out.values())
        handed.append((index, tuple(id(out[k]) for k in sorted(out))))
        return out

    pool.init_staging = init_staging
    res = eng.serve([GenerationRequest(prompt=p, max_new_tokens=b)
                     for p, b in zip(STAGED_PROMPTS, STAGED_BUDGETS)])
    assert [r.tokens for r in res] == want
    assert eng.schedule_report()["fused_steps"] > 0
    streamed = {ids for index, ids in handed if index == 0}
    assert len([1 for index, _ in handed if index == 0]) >= 2 and len(streamed) == 1


# --------------------------------------------------------------------------
# a graph's static outputs
# --------------------------------------------------------------------------


def test_spec_verify_copies_each_positions_logits(smoke, monkeypatch):
    """Step programs that return their logits in ONE static buffer, as a
    replayed graph does: the verify round copies each position's logits
    before the next position's step, so the spec tokens still equal the
    plain serve's (without the copies every position would read the last)."""
    cfg, params = smoke
    sm = ServingModel.prepare(cfg, params, max_len=MAX_LEN, slots=2, device="cpu")
    plain = [r.tokens for r in sm.engine(mode=Mode.HBCEM, chunk=4).serve(requests())]
    real = interleave.decode_only_step
    static = {}

    def replayed(params, cache, tokens, cfg, **kw):
        logits, out = real(params, cache, tokens, cfg, **kw)
        buf = static.setdefault(tuple(logits.shape), torch.empty_like(logits))
        buf.copy_(logits)
        return buf, out

    monkeypatch.setattr(interleave, "decode_only_step", replayed)
    eng = sm.engine(mode=Mode.HBCEM, chunk=4, spec=SpecConfig(draft=sm, k=3))
    spec = [r.tokens for r in eng.serve(requests())]
    assert eng.schedule_report()["spec"]["accepted"] > 0
    assert spec == plain

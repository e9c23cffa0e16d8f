"""The host side of the last three compiled programs, on the CPU: the spec
draft's feeds through the engine's ``StepGraphs`` on persistent lanes, the
pool's sampling program over static input buffers, and the in-place train
step (``adamw_update_``, ``train_step_``, ``TrainGraphs``, the loop that
owns its tensors, the checkpoint snapshot). No graph is captured here (there
is no card): on the CPU every program runs eagerly, and these tests hold the
eager bits, the graph keys and the buffers a capture relies on; one serve
goes through the capture path with a stand-in graph that replays its body.
``tests/test_torch_cuda.py`` holds the captured programs to eager ones on
the card.
"""
import dataclasses
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serve import sampling as jsampling  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import interleave  # noqa: E402
from repro_torch.core.pim_modes import Mode  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import prng, sampling  # noqa: E402
from repro_torch.serve.api import GenerationRequest, SamplingParams  # noqa: E402
from repro_torch.serve.serving_model import ServingModel  # noqa: E402
from repro_torch.serve.spec import SpecDecoder  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.train.loop import TrainConfig, run  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    AdamWConfig, OptState, adamw_update, adamw_update_, init_opt_state, tree_leaves, tree_map)
from repro_torch.train.train_step import TrainGraphs, train_step, train_step_  # noqa: E402

K = 3
MAX_LEN = 40


def _leaves(tree) -> list:
    return tree_leaves(list(tree) if isinstance(tree, tuple) else tree)


def _equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# --------------------------------------------------------------------------
# (a) the spec draft's feeds on persistent lanes
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def drafts():
    """The llama3-8b smoke (W8A8) and rwkv6 smoke draft artifacts, seeded."""
    out = {}
    for arch, over in (("llama3-8b", dict(quantized_decode=True)), ("rwkv6-1.6b", {})):
        cfg = get_config(arch, smoke=True).replace(**over)
        params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        out[arch] = ServingModel.prepare(cfg, params, max_len=MAX_LEN, slots=2, device="cpu")
    return out


def _decoder(sm):
    g = interleave.StepGraphs("cpu")
    return SpecDecoder(sm, sm, slots=2, max_len=MAX_LEN, k=K, graphs=g), g


def _lane(sd, sm, si=1, prompt=(3, 1, 4, 1, 5), nxt=9):
    req = GenerationRequest(prompt=list(prompt), max_new_tokens=8)
    sd.ensure_lane(si, 0, req, list(prompt) + [nxt], sm.cfg)
    return req


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-1.6b"])
def test_draft_feeds_keep_their_keys_across_rounds(drafts, arch, monkeypatch):
    """Every draft feed goes through the engine's ``StepGraphs``, on the same
    working lane each round: a feed's key depends only on its token count,
    so the catch-up of one token and the chained feeds share one key, and a
    catch-up length seen again replays its key."""
    sm = drafts[arch]
    sd, g = _decoder(sm)
    seen = []
    orig = interleave.StepGraphs.decode_only_step

    def spy(self, params, cache, tokens, cfg):
        seen.append((tokens.shape[1], self.key("decode_only", params, (cache,), (tokens,), cfg)))
        return orig(self, params, cache, tokens, cfg)

    monkeypatch.setattr(interleave.StepGraphs, "decode_only_step", spy)
    _lane(sd, sm)
    for emitted in ([7, 2], [5], [6, 8, 1], [4, 4]):     # next catch-ups of 2, 1, 3, 2 tokens
        d = sd.rollout(1, K, sm.cfg)
        assert len(d) == K
        sd.finish_round(1, emitted)
    sd.rollout(1, K, sm.cfg)
    by_len = {}
    for t, key in seen:
        by_len.setdefault(t, set()).add(key)
    assert sorted(by_len) == [1, 2, 3] and all(len(v) == 1 for v in by_len.values())
    assert len({k for v in by_len.values() for k in v}) == 3
    assert sd.catchup_lengths == {1, 2, 3}
    assert len(seen) == 5 * K and g.stats()["eager_steps"] == 5 * K


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-1.6b"])
def test_aborted_round_leaves_the_draft_pool_bit_identical(drafts, arch):
    """A rollout writes only the working lane and the slot's anchor: after an
    aborted round the draft pool (every leaf and every fill) is as it was,
    and the retried round drafts the same tokens; a committed round moves
    the lane by the catch-up."""
    sm = drafts[arch]
    sd, _ = _decoder(sm)
    _lane(sd, sm, si=0, prompt=(2, 7, 1, 8))
    _lane(sd, sm, si=1)
    sd.begin_round()
    first = sd.rollout(1, K, sm.cfg)
    sd.finish_round(1, [first[0], 3])
    before = {k: v.clone() for k, v in sd.pool.views().items()}
    fills = sd.pool._pos.copy()
    sd.begin_round()
    a = [sd.rollout(si, K, sm.cfg) for si in (0, 1)]
    sd.abort_round()
    after = sd.pool.views()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert (sd.pool._pos == fills).all()
    sd.begin_round()
    assert [sd.rollout(si, K, sm.cfg) for si in (0, 1)] == a
    sd.finish_round(1, [a[1][0]])
    assert int(sd.pool._pos[1]) == fills[1] + 2 and int(sd.pool._pos[0]) == fills[0]
    assert sd.pool.check_invariants() == []


def test_lane_copy_in_place_equals_the_cloning_copy(drafts):
    """``extract_lane_into`` fills the caller's buffers with what
    ``extract_lane`` clones, its fill included, and reads the pool only."""
    sm = drafts["rwkv6-1.6b"]
    sd, _ = _decoder(sm)
    _lane(sd, sm)
    lane = sd.pool.lane_buffers()
    ptrs = {k: v.data_ptr() for k, v in lane.items()}
    got = sd.pool.extract_lane_into(1, lane)
    want = sd.pool.extract_lane(1)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) and got[k].data_ptr() == ptrs[k] for k in want)
    assert got["pos"].tolist() == [5]


# --------------------------------------------------------------------------
# (b) the sampling program
# --------------------------------------------------------------------------


def _jax_sample(lg, done, keys, temps, ks, ps):
    return np.asarray(jsampling.sample_masked(
        jnp.asarray(lg), jnp.asarray(done), keys=jnp.asarray(keys, jnp.uint32),
        temperature=jnp.asarray(temps), top_k=jnp.asarray(ks), top_p=jnp.asarray(ps)))


@pytest.mark.parametrize("case", ["greedy", "sampled", "top_k", "top_p", "done", "mixed"])
def test_sampling_program_equals_plain_and_jax(case):
    """``StepGraphs.sample`` over host-built per-lane inputs (the static
    buffers' contents on the card) against the plain ``sample_masked`` and
    the JAX one, bit for bit; a verify position's logits read from a strided
    slice of the engine's verify buffer."""
    b, v = 4, 97
    rng = np.random.default_rng(len(case))
    lg = (rng.standard_normal((b, 1, v)) * 3).astype(np.float32)
    temps = np.full(b, 0.9, np.float32)
    ks = np.zeros(b, np.int32)
    ps = np.ones(b, np.float32)
    done = np.zeros(b, bool)
    if case == "greedy":
        temps[:] = 0.0
    elif case == "top_k":
        ks[:] = [1, 5, 0, v + 3]
    elif case == "top_p":
        ps[:] = [0.5, 0.9, 1e-9, 1.0]
    elif case == "done":
        done[[0, 2]] = True
    elif case == "mixed":
        temps[:] = [0.0, 0.7, 1.3, 0.0]
        ks[:] = [0, 8, 0, 3]
        ps[:] = [1.0, 0.8, 0.9, 1.0]
        done[3] = True
    keys = np.stack([np.asarray(prng.fold_in(sampling.request_key(s, [s, 1]), 4))
                     for s in range(b)])
    g = interleave.StepGraphs("cpu")
    buf = torch.zeros((b, K + 1, v))
    buf[:, 2:3].copy_(torch.from_numpy(lg))
    got = g.sample(buf[:, 2:3], torch.from_numpy(done), torch.from_numpy(keys),
                   torch.from_numpy(temps), torch.from_numpy(ks).long(),
                   torch.from_numpy(ps)).numpy()
    plain = sampling.sample_masked(
        torch.from_numpy(lg), torch.from_numpy(done), keys=torch.from_numpy(keys),
        temperature=torch.from_numpy(temps), top_k=torch.from_numpy(ks).long(),
        top_p=torch.from_numpy(ps)).numpy()
    assert (got == plain).all() and (got == _jax_sample(lg, done, keys, temps, ks, ps)).all()
    assert (got[done] == 0).all()
    if case == "greedy":
        fast = g.sample(buf[:, 2:3], torch.from_numpy(done)).numpy()
        assert (fast == got).all() and (fast == lg[:, 0].argmax(-1)).all()
    assert g.stats()["eager_steps"] == 1 + (case == "greedy")


class _Replayed:
    """A CUDA graph's stand-in on the CPU: the capture ran the body once (the
    call's real step); each later replay runs it again over the same input
    buffers and copies its outputs into the first call's (static outputs)."""

    def __init__(self, body, bufs, out):
        self.body, self.bufs, self.out, self.fresh = body, bufs, out, True

    def replay(self):
        if self.fresh:
            self.fresh = False
            return
        new = self.body(self.bufs, None)
        for a, b in zip(_leaves(self.out), _leaves(tuple(new))):
            if a is not b:
                a.copy_(b)


def _stand_in_capture(self, program, cfg, bufs, body, branches):
    out = tuple(body(bufs, None))
    return interleave._Graph(_Replayed(body, bufs, out), bufs, out, {})


@pytest.mark.parametrize("mode,temperature", [("HBCEM", 0.0), ("LBIM", 0.8)])
def test_sampling_keys_stay_within_the_step_graphs(drafts, mode, temperature, monkeypatch):
    """A serve through the capture path (a stand-in graph that replays the
    body on the CPU): a step key's eager first call is sampled eagerly with
    no key, so the sampling keys stay at most the step graphs, every step
    ran eagerly only as a key's first call, and the tokens equal the eager
    serve's."""
    sm = drafts["llama3-8b"]
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9], [2, 7]]

    def serve():
        eng = sm.engine(mode=getattr(Mode, mode), chunk=4, prefix_cache=False)
        res = eng.serve([GenerationRequest(prompt=p, max_new_tokens=6,
                                           sampling=SamplingParams(temperature=temperature,
                                                                   seed=i))
                         for i, p in enumerate(prompts)])
        return [r.tokens for r in res], eng.graphs

    with interleave.eager():
        want, _ = serve()
    monkeypatch.setattr(interleave.GraphCache, "_captures", lambda self: True)
    monkeypatch.setattr(interleave.GraphCache, "_capture", _stand_in_capture)
    got, g = serve()
    assert got == want
    st, progs = g.stats(), g.programs()
    samples = progs.get("sample", 0) + progs.get("greedy_sample", 0)
    step_graphs = sum(1 for key in g._graphs if key[0] not in ("sample", "greedy_sample"))
    assert st["replays"] > 0 and samples > 0 and st["unheld"] > 0
    assert samples <= step_graphs
    assert st["eager_steps"] == st["keys"] and st["unheld"] <= st["keys"] - samples


def test_threefry_takes_int_key_words_as_scalars():
    """An int key word stays a Python scalar (no device tensor is made from
    it) and hashes as the same word in a tensor does."""
    x1 = torch.arange(6, dtype=torch.int64)
    x2 = torch.arange(6, dtype=torch.int64) * 977
    for k1, k2 in ((0, 42), (0xDEADBEEF, 0xFFFFFFFF), (2**32 + 5, 7)):
        a = prng.threefry2x32(k1, k2, x1, x2)
        b = prng.threefry2x32(torch.tensor(k1 & prng.MASK), torch.tensor(k2), x1, x2)
        assert all(torch.equal(p, q) for p, q in zip(a, b))
    u = prng.uniform(prng.PRNGKey(3), 1000, 0.25, 0.75)
    assert u.dtype == torch.float32 and float(u.min()) >= 0.25 and float(u.max()) < 0.75


# --------------------------------------------------------------------------
# (c) the in-place AdamW
# --------------------------------------------------------------------------


def _tree(shapes, rng, scale, dtype):
    return {k: torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32)).to(dtype)
            for k, s in shapes.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_in_place_is_the_functional_update_bit_for_bit(dtype):
    """``adamw_update_`` over 3 steps (warm-up, then the cosine; the clip
    active) writes exactly the bits ``adamw_update`` returns into the same
    tensors, and stays within the JAX update's f32 rounding (XLA fuses the
    elementwise chain, so a few values differ from it by an ulp, as the
    functional update's do)."""
    dt = getattr(torch, dtype)
    shapes = {"a": (7, 5), "b": (13,), "c": (2, 3, 4)}
    rng = np.random.default_rng(1)
    p0 = _tree(shapes, rng, 1.0, dt)
    c = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=0.5)
    f_p, f_s = p0, init_opt_state(p0)
    i_p = tree_map(torch.clone, p0)
    i_s = init_opt_state(i_p)
    addrs = [t.data_ptr() for t in _leaves(i_p) + _leaves(i_s)]
    j_p = {k: jnp.asarray(v.float().numpy()).astype(jnp.dtype(dtype)) for k, v in p0.items()}
    j_s = jopt.init_opt_state(j_p)
    jc = jopt.AdamWConfig(**dataclasses.asdict(c))
    for step in range(3):
        g = _tree(shapes, rng, 4.0, dt)
        f_p, f_s, fst = adamw_update(f_p, g, f_s, c)
        _, _, ist = adamw_update_(i_p, g, i_s, c)
        j_p, j_s, jst = jax.jit(jopt.adamw_update, static_argnums=3)(
            j_p, {k: jnp.asarray(v.float().numpy()).astype(jnp.dtype(dtype))
                  for k, v in g.items()}, j_s, jc)
        assert float(fst["grad_norm"]) > c.clip_norm
        assert torch.equal(fst["lr"], ist["lr"]) and torch.equal(fst["grad_norm"],
                                                                  ist["grad_norm"])
        assert _equal(f_p, i_p) and _equal(f_s, i_s), step
        for k in shapes:    # XLA's fused f32 arithmetic rounds a few moments an ulp apart
            np.testing.assert_allclose(i_p[k].float().numpy(), np.asarray(j_p[k], np.float32),
                                       rtol=1e-6 if dtype == "float32" else 2.0**-8, atol=1e-7)
            for ours, theirs in ((i_s.m[k], j_s.m[k]), (i_s.v[k], j_s.v[k])):
                np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5,
                                           atol=1e-7)
    assert [t.data_ptr() for t in _leaves(i_p) + _leaves(i_s)] == addrs
    assert int(i_s.step) == 3 and i_s.step.dtype == torch.int32


# --------------------------------------------------------------------------
# (d) the loop that owns its tensors, and the checkpoint snapshot
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    return get_config("llama3-8b", smoke=True).replace(dtype="float32", param_dtype="float32",
                                                       n_layers=1)


def _dc(cfg):
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=4)


@pytest.mark.parametrize("accum", [1, 2])
def test_in_place_loop_equals_the_functional_loop(tiny, accum):
    """``loop.run`` (the in-place step through its ``TrainGraphs``, eager
    here) gives the functional loop's losses and params bit for bit, and
    never writes the params tree it is given."""
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4, clip_norm=0.1)
    tc = TrainConfig(steps=3, log_every=0, accum=accum, opt=opt)
    p0 = TM.init_params(tiny, torch.Generator().manual_seed(tc.seed), device="cpu")
    given = tree_map(torch.clone, p0)
    pi, si, hi = run(tiny, _dc(tiny), tc, params=given, log=lambda *a: None, device="cpu")
    assert _equal(given, p0)
    pf, sf, losses = p0, init_opt_state(p0), []
    data = SyntheticLM(_dc(tiny))
    for step in range(tc.steps):
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(step).items()}
        pf, sf, m = train_step(pf, sf, batch, tiny, opt, accum)
        losses.append(float(m["loss"]))
    assert [h["loss"] for h in hi] == losses
    assert _equal(pf, pi) and _equal(sf, si)


def test_checkpoint_holds_the_params_of_its_step(tiny, tmp_path, monkeypatch):
    """An async save at step n, then step n+1 in place while the writer
    waits: the checkpoint holds step n's params and state (the snapshot is a
    copy taken before ``save`` returns), and resuming from it replays the
    uninterrupted run exactly."""
    cfg = tiny
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = init_opt_state(params)
    data = SyntheticLM(_dc(cfg))
    g = TrainGraphs("cpu")
    g.step(params, state, {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()},
           cfg, opt)
    at_save = (tree_map(torch.clone, params), OptState(*(tree_map(torch.clone, x)
                                                         for x in state)))
    go = threading.Event()
    savez = np.savez
    monkeypatch.setattr(checkpoint.np, "savez", lambda *a, **kw: (go.wait(30), savez(*a, **kw)))
    t = checkpoint.save(str(tmp_path), 1, params, state, extra={"next_step": 1}, async_=True)
    g.step(params, state, {k: torch.from_numpy(v) for k, v in data.batch_at(1).items()},
           cfg, opt)
    assert not _equal(params, at_save[0])
    go.set()
    t.join()
    got_p, got_s, _ = checkpoint.restore(str(tmp_path), 1, params, state)
    assert _equal(got_p, at_save[0]) and _equal(got_s, at_save[1])
    p2, s2, _ = train_step(got_p, got_s, {k: torch.from_numpy(v)
                                          for k, v in data.batch_at(1).items()}, cfg, opt)
    assert _equal(p2, params) and _equal(s2, state)


def test_train_step_in_place_returns_the_functional_metrics(tiny):
    """``train_step_`` writes the functional step's params and state into its
    inputs and returns its metrics."""
    params = TM.init_params(tiny, torch.Generator().manual_seed(2), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(_dc(tiny)).batch_at(0).items()}
    opt = AdamWConfig(warmup_steps=1, total_steps=3)
    pf, sf, mf = train_step(params, init_opt_state(params), batch, tiny, opt, 2)
    state = init_opt_state(params)
    mi = train_step_(params, state, batch, tiny, opt, 2)
    assert _equal(pf, params) and _equal(sf, state)
    assert all(torch.equal(mf[k], mi[k]) for k in ("loss", "lr", "grad_norm"))

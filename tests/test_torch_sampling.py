"""The port's sampled decoding against ``jax.random`` and
``repro.serve.sampling``, on the CPU.

The port carries its own threefry (``repro_torch.serve.prng``): its bits,
``fold_in``, ``PRNGKey`` and uniforms must equal ``jax.random``'s exactly, and
its Gumbel noise must be within one f32 ulp at the scale of the value or of 1
(``-log(-log(u))``: the two logs may each differ from XLA's by an ulp, and an
ulp of the inner log, near 1, is an absolute error near 0 in the outer one).
``request_key``/``token_key`` must be exact and ``sample_masked`` must give
the same tokens on the same logits. The contracts of
``tests/test_sampling_determinism.py`` are re-established on the port, and
the sampled engine's tokens must equal the JAX engine's at f32 smoke in every
mode, whatever the admission order.
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
from repro.serve import sampling as jsampling  # noqa: E402
from repro.serve.api import GenerationRequest as JReq  # noqa: E402
from repro.serve.api import SamplingParams as JSP  # noqa: E402
from repro.serve.serving_model import ServingModel as JServing  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.pim_modes import Mode  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import prng, sampling  # noqa: E402
from repro_torch.serve.api import GenerationRequest, SamplingParams  # noqa: E402
from repro_torch.serve.serving_model import ServingModel  # noqa: E402

MODES = ["BLOCKED", "HBCEM", "LBIM"]
EPS = np.finfo(np.float32).eps
TINY = np.finfo(np.float32).tiny
SEEDS = [0, 7, 12345, -3, 2**33 + 9]


def _jkey(seed):
    return np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)


# --------------------------------------------------------------------------
# threefry
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_match_jax(seed):
    k = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    assert tk.tolist() == _jkey(seed).tolist()
    for d in (0, 1, 5, 123456789, 2**32 - 1):
        assert prng.fold_in(tk, d).tolist() == \
            np.asarray(jax.random.fold_in(k, d)).astype(np.int64).tolist()
    for n in (1, 5, 17, 1000):
        want = np.asarray(jax.random.bits(k, (n,), jnp.uint32)).astype(np.int64)
        assert (prng.random_bits(tk, n).numpy() == want).all()
        u = np.asarray(jax.random.uniform(k, (n,), minval=TINY, maxval=1.0))
        assert (prng.uniform(tk, n, TINY, 1.0).numpy() == u).all()
        u01 = np.asarray(jax.random.uniform(k, (n,)))
        assert (prng.uniform(tk, n).numpy() == u01).all()


def test_batched_fold_in_matches_vmap():
    base = jnp.stack([jax.random.PRNGKey(s) for s in (1, 2, 3)])
    offs = [0, 17, 2**31 + 5]
    want = np.asarray(jax.vmap(jax.random.fold_in)(base, jnp.asarray(offs, jnp.uint32)))
    got = prng.fold_in(torch.tensor(np.asarray(base).astype(np.int64)),
                       torch.tensor(offs, dtype=torch.int64))
    assert got.tolist() == want.astype(np.int64).tolist()


@pytest.mark.parametrize("seed", range(6))
def test_gumbel_within_an_ulp(seed):
    k = jax.random.PRNGKey(seed)
    n = 4096
    want = np.asarray(jax.random.gumbel(k, (n,)))
    got = prng.gumbel(prng.PRNGKey(seed), n).numpy()
    assert (np.abs(got - want) <= EPS * np.maximum(1.0, np.abs(want))).all()
    # the inner log on the same uniforms: one ulp of XLA's
    u = prng.uniform(prng.PRNGKey(seed), n, TINY, 1.0)
    inner = np.asarray(jnp.log(jnp.asarray(u.numpy())))
    ulps = np.abs(torch.log(u).numpy().view(np.int32).astype(np.int64)
                  - inner.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


@pytest.mark.parametrize("seed", range(4))
def test_categorical_matches_jax(seed):
    rng = np.random.default_rng(seed)
    lg = (rng.standard_normal((3, 300)) * 3).astype(np.float32)
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(seed), i) for i in range(3)])
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, jnp.asarray(lg)))
    got = prng.categorical(torch.tensor(np.asarray(keys).astype(np.int64)), torch.tensor(lg))
    assert got.tolist() == want.tolist()


# --------------------------------------------------------------------------
# request keys and the masked sampler
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed,prompt", [(7, [1, 2, 3]), (7, [3, 2, 1]), (8, [1, 2, 3]),
                                         (7, [3]), (7, [1, 1]), (0, list(range(300))),
                                         (2**40 + 1, [255] * 9)])
def test_request_and_token_keys_match_jax(seed, prompt):
    jk = jsampling.request_key(seed, prompt)
    tk = sampling.request_key(seed, prompt)
    assert tk.tolist() == np.asarray(jk).astype(np.int64).tolist()
    for idx in (0, 1, 9, 1000):
        assert sampling.token_key(tk, idx).tolist() == \
            np.asarray(jsampling.token_key(jk, idx)).astype(np.int64).tolist()


def _draw(rng, b, v):
    lg = (rng.standard_normal((b, 1, v)) * rng.uniform(0.5, 5)).astype(np.float32)
    temps = rng.choice([0.0, 0.7, 1.3], b).astype(np.float32)
    ks = rng.choice([0, 1, 3, 8, v, v + 5], b).astype(np.int32)
    ps = rng.choice([1.0, 0.9, 0.5, 1e-9], b).astype(np.float32)
    done = rng.random(b) < 0.2
    seeds = rng.integers(0, 1000, b)
    return lg, temps, ks, ps, done, seeds


def _both(lg, done, keys, temps, ks, ps):
    j = np.asarray(jsampling.sample_masked(
        jnp.asarray(lg), jnp.asarray(done), keys=jnp.asarray(keys, jnp.uint32),
        temperature=jnp.asarray(temps), top_k=jnp.asarray(ks), top_p=jnp.asarray(ps)))
    t = sampling.sample_masked(
        torch.tensor(lg), torch.tensor(done), keys=torch.tensor(np.asarray(keys, np.int64)),
        temperature=torch.tensor(temps), top_k=torch.tensor(ks), top_p=torch.tensor(ps))
    return j, t.numpy()


@pytest.mark.parametrize("seed", range(5))
def test_sample_masked_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        # a few vocab sizes: each new shape recompiles the jitted JAX sampler
        b, v = 4, int(rng.choice([17, 64, 257]))
        lg, temps, ks, ps, done, seeds = _draw(rng, b, v)
        keys = np.stack([_jkey(int(s)) for s in seeds])
        j, t = _both(lg, done, keys, temps, ks, ps)
        assert (j == t).all()
        jf = np.asarray(jax.vmap(jsampling._filter_top_k_top_p)(
            jnp.asarray(lg[:, 0]), jnp.asarray(ks), jnp.asarray(ps)))
        tf = sampling._filter_top_k_top_p(torch.tensor(lg[:, 0]), torch.tensor(ks).long(),
                                          torch.tensor(ps)).numpy()
        assert (jf == tf).all()


@pytest.mark.parametrize("temperature,top_k", [(0.9, 3), (1.0, 0), (0.0, 0)])
def test_legacy_sample_matches_jax(temperature, top_k):
    lg = np.random.default_rng(4).standard_normal((3, 1, 40)).astype(np.float32)
    k = jax.random.PRNGKey(11)
    j = np.asarray(jsampling.sample(jnp.asarray(lg), k, temperature, top_k))
    t = sampling.sample(torch.tensor(lg), prng.PRNGKey(11), temperature, top_k).numpy()
    assert (j == t).all()


# the cases of tests/test_sampling_determinism.py, on the port and against JAX
def _keys(b, seeds=None):
    return np.stack([_jkey(s) for s in (seeds or list(range(b)))])


def _logits(b, v, seed):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (b, 1, v)))


def _run(lg, temps, ks=None, ps=None, done=None):
    b = lg.shape[0]
    done = np.zeros((b,), bool) if done is None else np.asarray(done)
    return _both(lg, done, _keys(b), np.asarray(temps, np.float32),
                 np.asarray(ks or [0] * b, np.int32),
                 np.asarray(ps or [1.0] * b, np.float32))


def _greedy(lg):
    return sampling.greedy(torch.tensor(lg)).numpy()


def _case_temperature_zero_is_exact_greedy():
    lg = _logits(3, 17, 0)
    j, t = _run(lg, [0.0] * 3)
    assert (t == _greedy(lg)).all() and (j == t).all()
    assert (sampling.greedy_masked(torch.tensor(lg), torch.zeros(3, dtype=torch.bool))
            .numpy() == _greedy(lg)).all()


def _case_done_lanes_emit_pad():
    j, t = _run(_logits(3, 17, 0), [0.9] * 3, done=[True, False, True])
    assert t[0] == 0 and t[2] == 0 and (j == t).all()


def _case_top_k_one_and_tiny_top_p_collapse_to_argmax():
    lg = _logits(4, 33, 3)
    for kw in (dict(ks=[1] * 4), dict(ps=[1e-9] * 4)):
        j, t = _run(lg, [1.3] * 4, **kw)
        assert (t == _greedy(lg)).all() and (j == t).all()


def _case_top_k_geq_vocab_is_exact_noop():
    lg = _logits(4, 17, 9)
    _, base = _run(lg, [1.1] * 4, ks=[0] * 4)
    for k in (17, 18, 1000):
        assert (_run(lg, [1.1] * 4, ks=[k] * 4)[1] == base).all()
    row = torch.tensor(lg[:1, 0, :])
    withp = sampling._filter_top_k_top_p(row, torch.tensor([17]), torch.tensor([0.6]))
    nop = sampling._filter_top_k_top_p(row, torch.tensor([0]), torch.tensor([0.6]))
    assert torch.equal(withp, nop)


def _case_top_p_one_is_exact_noop():
    lg = _logits(3, 33, 4)
    assert (_run(lg, [0.9] * 3, ps=[1.0] * 3)[1] == _run(lg, [0.9] * 3)[1]).all()
    rows = torch.tensor(lg[:, 0, :])
    assert torch.equal(sampling._filter_top_k_top_p(rows, torch.zeros(3, dtype=torch.long),
                                                    torch.ones(3)), rows)
    assert torch.equal(sampling._filter_top_k_top_p(rows, torch.full((3,), 33),
                                                    torch.ones(3)), rows)


def _case_mixed_greedy_and_sampled_lanes_do_not_interact():
    lg = _logits(3, 29, 5)
    j, mixed = _run(lg, [0.0, 0.8, 1.5])
    assert mixed[0] == _greedy(lg)[0] and (j == mixed).all()
    assert (_run(lg, [0.0, 0.8, 1.5])[1] == mixed).all()


def _case_request_key_ignores_scheduling_but_not_prompt():
    a = sampling.request_key(7, [1, 2, 3]).tolist()
    assert a == sampling.request_key(7, [1, 2, 3]).tolist()
    assert a != sampling.request_key(7, [3, 2, 1]).tolist()
    assert a != sampling.request_key(8, [1, 2, 3]).tolist()
    assert sampling.request_key(7, [3]).tolist() != sampling.request_key(7, [1, 1]).tolist()


CASES = {name[len("_case_"):]: fn for name, fn in list(globals().items())
         if name.startswith("_case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sampling_determinism_contract(case):
    CASES[case]()


# --------------------------------------------------------------------------
# the sampled engine against the JAX engine
# --------------------------------------------------------------------------

MAX_LEN = 48
SAMPLERS = [dict(temperature=0.8, seed=1), dict(temperature=1.1, top_k=8, seed=2), dict(),
            dict(temperature=0.9, top_p=0.7, seed=3),
            dict(temperature=0.7, top_k=16, top_p=0.9, seed=4)]


def _spec_requests(vocab):
    rng = np.random.default_rng(11)
    return [(list(map(int, rng.integers(1, vocab, int(rng.integers(2, 7))))),
             int(rng.integers(2, 6)), sp) for sp in SAMPLERS]


@pytest.fixture(scope="module")
def engines():
    jcfg = get_config("llama3-8b", smoke=True).replace(dtype="float32",
                                                        param_dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    yield (JServing.prepare(jcfg, jp, max_len=MAX_LEN, slots=3),
           ServingModel.prepare(tcfg, tp, max_len=MAX_LEN, slots=3, device="cpu"),
           _spec_requests(jcfg.vocab_size))
    jax.clear_caches()


def _tserve(sm, specs, order, slots, mode):
    out = sm.engine(slots=slots, mode=Mode[mode], chunk=2).serve(
        [GenerationRequest(prompt=specs[i][0], max_new_tokens=specs[i][1],
                           sampling=SamplingParams(**specs[i][2])) for i in order])
    return {order[j]: out[j].tokens for j in range(len(order))}


@pytest.mark.parametrize("mode", MODES)
def test_sampled_engine_matches_jax(engines, mode):
    jsm, tsm, specs = engines
    jout = jsm.engine(slots=2, mode=JMode[mode], chunk=2).serve(
        [JReq(prompt=p, max_new_tokens=b, sampling=JSP(**sp)) for p, b, sp in specs])
    got = _tserve(tsm, specs, list(range(len(specs))), 2, mode)
    assert got == {i: r.tokens for i, r in enumerate(jout)}
    assert any(got[i] != _tserve(tsm, [(p, b, {}) for p, b, _ in specs], [i], 1, mode)[i]
               for i in range(len(specs)) if specs[i][2])   # sampling changed something


def test_sampled_engine_any_admission_order(engines):
    """Same seed and request set: the same tokens whatever the admission
    order, pool width, mode or sibling lifetimes (solo pools)."""
    _, tsm, specs = engines
    n = len(specs)
    base = _tserve(tsm, specs, list(range(n)), 2, "HBCEM")
    assert _tserve(tsm, specs, [2, 0, 4, 1, 3], 3, "LBIM") == base
    solo = {}
    for i in range(n):
        solo.update(_tserve(tsm, specs, [i], 1, "BLOCKED"))
    assert solo == base

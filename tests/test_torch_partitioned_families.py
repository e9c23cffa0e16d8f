"""The partitioned decode and prefill programs of gemma2-27b, internvl2-2b and
seamless-m4t-large-v2 against the JAX package's unsharded ones, on the CPU
over real ``gloo`` groups.

* ``models.model.prefill`` + 6 greedy ``decode_step``s with ``mesh=`` on
  meshes (data, model) = (1, 2), (2, 1) and (2, 2), for the three smoke
  configs in f32, and ``gemma2-27b+sp`` (``seq_parallel=True``) on (1, 2):
  gemma2's tied head, softcaps, post-norms and local window (8 slots, under
  16-token prompts); internvl2-2b's 4-row image prefix; seamless's encoder
  over 12 frames, a one-token decoder input and the cross K/V. internvl2-2b
  and seamless run with ``vocab_size=257`` on both sides, which no mesh
  divides: GSPMD's padded vocab (``dist.sharding``), the logits gathered
  over ``model`` with the pad dropped. Every rank's logits (a divisible
  vocab's gathered by its coordinates), greedy tokens and cache rows (the
  lanes, and ``cross_k``/``cross_v``) match ``repro.models.model.prefill``
  + ``decode_step`` on the same numpy params to ``rtol=atol=1e-5``. One
  two-rank and one four-rank group run every case.
* Counts: each rank's ``CollectiveCounter`` totals equal the ``meta``
  count of the same drive over a ``fake`` group of the mesh's size.
* Units: a padded leaf's shards and ``full_tree``; the padded
  vocab-parallel cross-entropy against the unpadded one; what
  ``check_partitioned`` still refuses.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.dist import sharding as shard_lib  # noqa: E402
from repro_torch.dist.collectives import TensorParallel  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import partitioned  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ARCHS = ["gemma2-27b", "internvl2-2b", "seamless-m4t-large-v2"]
CASES = {2: ARCHS + ["gemma2-27b+sp"], 4: ARCHS}      # world size -> cases
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}           # world size -> meshes
PADDED_VOCAB = 257          # internvl2-2b and seamless: no mesh divides it
B, S, SRC, STEPS, MAX_LEN = 4, 16, 12, 6, 32
TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(case):
    arch = case.split("+")[0]
    jcfg = get_config(arch, smoke=True).replace(dtype="float32", param_dtype="float32")
    if jcfg.family in ("vlm", "audio"):
        jcfg = jcfg.replace(vocab_size=PADDED_VOCAB)
    tcfg = ModelConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    return jcfg, tcfg.replace(seq_parallel=case.endswith("+sp"))


def _inputs(jcfg) -> dict:
    """The global numpy batch: prompts (audio: one decoder token a row over
    SRC frames), a vlm's image prefix."""
    r = np.random.default_rng(4)
    out = {"tokens": r.integers(1, jcfg.vocab_size,
                                (B, 1 if jcfg.family == "audio" else S)).astype(np.int32)}
    if jcfg.family == "vlm":
        out["prefix_embeds"] = r.standard_normal(
            (B, jcfg.n_prefix_tokens, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "audio":
        out["src_frames"] = r.standard_normal((B, SRC, jcfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's unsharded prefill + greedy decode steps per arch
    (jitted): (numpy params, inputs, logits a step, tokens (B, STEPS + 1),
    the cache's leaves but ``pos``)."""
    out = {}
    for arch in ARCHS:
        jcfg, _ = _configs(arch)
        jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
        inputs = _inputs(jcfg)
        prefill = jax.jit(lambda p, b, c=jcfg: JM.prefill(p, b, c, max_len=MAX_LEN))
        step = jax.jit(lambda p, cache, t, c=jcfg: JM.decode_step(p, cache, t, c))
        logits, cache = prefill(jp, {k: jnp.asarray(v) for k, v in inputs.items()})
        outs, greedy = [np.asarray(logits)], [np.asarray(logits)[:, -1].argmax(-1)[:, None]]
        for _ in range(STEPS):
            logits, cache = step(jp, cache, jnp.asarray(greedy[-1], jnp.int32))
            outs.append(np.asarray(logits))
            greedy.append(np.asarray(logits)[:, -1].argmax(-1)[:, None])
        out[arch] = (jax.tree_util.tree_map(np.asarray, jp), inputs, outs,
                     np.concatenate(greedy, axis=1),
                     {k: np.asarray(v) for k, v in cache.items() if k != "pos"})
    return out


@pytest.fixture(scope="module")
def groups(jax_runs):
    """Each world size's cases on its meshes: one spawn each, every rank's
    results in rank order."""
    out = {}
    for world, cases in CASES.items():
        jobs = [(_configs(case)[1], *jax_runs[case.split("+")[0]][:2]) for case in cases]
        out[world] = tmesh.spawn(partitioned.rank_run, world, jobs, MESHES[world], MAX_LEN,
                                 STEPS, "cpu")
    return out


def _case_mesh():
    return [(case, shape) for world in CASES for case in CASES[world]
            for shape in MESHES[world] if not (case.endswith("+sp") and shape != (1, 2))]


def _ranks(groups, case, shape):
    world = shape[0] * shape[1]
    ci, mi = CASES[world].index(case), MESHES[world].index(shape)
    return [r[ci][mi] for r in groups[world]]


@pytest.mark.parametrize("case,shape", _case_mesh())
def test_partitioned_families_match_jax(groups, jax_runs, case, shape):
    """Logits (gathered by coordinates, or whole where the vocab is padded),
    greedy tokens and every rank's cache rows against the JAX unsharded run."""
    cfg = _configs(case)[1]
    jlogits, jgreedy, jcache = jax_runs[case.split("+")[0]][2:]
    nd, nm = shape
    rows = B // nd
    v = cfg.vocab_size
    padded = v % nm != 0
    got = [np.full_like(x, np.nan) for x in jlogits]
    for r in _ranks(groups, case, shape):
        di, mi = r["coords"]["data"], r["coords"]["model"]
        rs = slice(di * rows, (di + 1) * rows)
        cols = slice(None) if padded else slice(mi * v // nm, (mi + 1) * v // nm)
        assert r["logits"][0].shape == (rows, 1, v if padded else v // nm)
        for g, x in zip(got, r["logits"]):
            if padded and mi:       # every rank holds the gathered logits: the same
                np.testing.assert_array_equal(x, g[rs])
            g[rs, :, cols] = x
        np.testing.assert_array_equal(r["tokens"], jgreedy[rs])
        assert set(jcache) == {k for k in r if k in ("k", "v", "cross_k", "cross_v")}
        for key, want in jcache.items():
            np.testing.assert_allclose(r[key], want[:, rs], **TOL, err_msg=key)
    for g, want in zip(got, jlogits):
        np.testing.assert_allclose(g, want, **TOL)


@pytest.mark.parametrize("shape", [s for w in MESHES for s in MESHES[w]])
def test_family_counts_meta_equal_gloo(groups, shape):
    """Kind by kind: every gloo rank's count equals the meta count over a
    fake group; a padded vocab gathers its logits (one all-gather a call
    beside the K/V gathers), a divisible one gathers them for the greedy
    token."""
    world = shape[0] * shape[1]
    for case in CASES[world]:
        if case.endswith("+sp") and shape != (1, 2):
            continue
        cfg = _configs(case)[1]
        inputs = _inputs(_configs(case)[0])
        extra = {k: v.shape for k, v in inputs.items() if k != "tokens"}
        meta = partitioned.count_run(cfg, shape, B, inputs["tokens"].shape[1], MAX_LEN, STEPS,
                                     extra)
        for r in _ranks(groups, case, shape):
            assert r["collectives"] == meta, (case, r["coords"])
            assert not any(r["launches"].values())   # the CPU runs the plain versions
        if shape[1] > 1:
            assert meta["_counts"]["all-gather"] >= (STEPS + 1) * (1 + cfg.n_layers), case
        else:
            assert meta == {"_counts": {}}, case


def _fake_rank(world: int, rank: int):
    """A ``fake`` default group of ``world`` ranks as ``rank`` sees it (its
    collectives move nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)


@pytest.mark.parametrize("n", [2, 4])
def test_padded_vocab_shards_and_full_tree(n):
    """internvl2-2b-smoke at vocab 257 over ``model`` n: each rank's embedding
    rows and head columns are ``ceil(257 / n)``, the last rank's tail zeros,
    the ranks' parts concatenated the padded table; ``full_tree`` strips the
    pad (its shapes); the ZeRO-1 plan and moments take the padded shapes."""
    import torch.distributed as dist

    cfg = t_get_config("internvl2-2b", smoke=True).replace(vocab_size=PADDED_VOCAB,
                                                          dtype="float32",
                                                          param_dtype="float32")
    full = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    part = -(-PADDED_VOCAB // n)
    embeds, heads = [], []
    for rank in range(n):
        _fake_rank(n, rank)
        try:
            mesh = tmesh.make_mesh((1, n), partitioned.AXES, device="cpu")
            local = partitioned.shard_params(full, mesh)
            assert local["embed"]["w"].shape == (part, cfg.d_model)
            assert local["lm_head"]["w"].shape == (cfg.d_model, part)
            embeds.append(local["embed"]["w"])
            heads.append(local["lm_head"]["w"])
            sh = shard_lib.param_shardings(full, mesh)
            assert sh["embed"]["w"].padded == ((0, PADDED_VOCAB),)
            assert sh["lm_head"]["w"].padded == ((1, PADDED_VOCAB),)
            assert sh["final_norm"]["scale"].padded == ()
            for key in ("embed", "lm_head"):
                back = shard_lib.full_tree(local[key], sh[key], mesh)
                assert back["w"].shape == full[key]["w"].shape
            plan = shard_lib.zero1_plan(cfg, mesh)
            assert plan["embed/w"].param_shape == (part, cfg.d_model)
            assert plan["lm_head/w"].moment_shape == (cfg.d_model, part)
            state = shard_lib.local_opt_state(cfg, mesh, "cpu")
            assert state.m["embed"]["w"].shape == (part, cfg.d_model)
        finally:
            dist.destroy_process_group()
    pad = part * n - PADDED_VOCAB
    assert pad > 0
    torch.testing.assert_close(embeds[-1][part - pad:], torch.zeros(pad, cfg.d_model))
    torch.testing.assert_close(heads[-1][:, part - pad:], torch.zeros(cfg.d_model, pad))
    torch.testing.assert_close(torch.cat(embeds)[:PADDED_VOCAB], full["embed"]["w"],
                               rtol=0, atol=0)
    torch.testing.assert_close(torch.cat(heads, dim=1)[:, :PADDED_VOCAB],
                               full["lm_head"]["w"], rtol=0, atol=0)


def test_padded_vocab_parallel_xent_is_the_unpadded_loss():
    """The rank that holds the pad: logits over a padded vocab whose pad
    columns hold large values equal the unpadded loss, softcap applied, and
    the pad columns take no gradient; the gold logit of a label on the rank
    counts."""
    vocab, pad = 257, 7
    gen = torch.Generator().manual_seed(5)
    logits = torch.randn((3, 5, vocab + pad), generator=gen) * 4
    logits[..., vocab:] = 1e4
    labels = torch.randint(0, vocab, (3, 5), generator=gen)
    with tmesh.counting_mesh((1, 1), partitioned.AXES) as m:
        tp = TensorParallel(m)
        live = logits.clone().requires_grad_(True)
        loss = TM._vocab_parallel_xent(TM.L.softcap(live, 30.0), labels, tp, vocab)
        loss.backward()
    capped = TM.L.softcap(logits[..., :vocab], 30.0)
    want = (torch.logsumexp(capped, -1) - torch.gather(capped, -1, labels[..., None])[..., 0])
    torch.testing.assert_close(loss, want.sum(), rtol=1e-6, atol=1e-5)
    assert torch.all(live.grad[..., vocab:] == 0)
    assert torch.all(live.grad[..., :vocab] != 0)


def test_check_partitioned_refuses_what_it_does_not_cover():
    """gemma2, vlm and audio are covered; W8A8, the paged cache, gemma2's
    rings and the MoE, hybrid and ssm families raise, saying so."""
    with tmesh.counting_mesh((1, 2), partitioned.AXES) as m:
        for arch in ARCHS:
            TM.check_partitioned(t_get_config(arch, smoke=True), m)
        gemma = t_get_config("gemma2-27b", smoke=True)
        with pytest.raises(ValueError, match="W8A8"):
            TM.check_partitioned(gemma.replace(quantized_decode=True), m)
        with pytest.raises(ValueError, match="paged"):
            TM.check_partitioned(gemma, m, {"k_pages": None, "pos": None})
        with pytest.raises(ValueError, match="rings"):
            TM.check_partitioned(gemma.replace(windowed_kv_cache=True), m)
        with pytest.raises(ValueError, match="rings"):
            TM.check_partitioned(gemma, m, {"k_loc": None, "k": None, "pos": None})
        for arch, family in (("olmoe-1b-7b", "moe"), ("phi3.5-moe-42b-a6.6b", "moe"),
                             ("zamba2-7b", "hybrid"), ("rwkv6-1.6b", "ssm")):
            with pytest.raises(ValueError, match=f"the {family} family"):
                TM.check_partitioned(t_get_config(arch, smoke=True), m)

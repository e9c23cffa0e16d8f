"""The partitioned decode and prefill programs against the JAX package's
unsharded ones, on the CPU over real ``gloo`` groups.

* ``models.model.prefill`` + 6 greedy ``decode_step``s with ``mesh=`` on
  meshes (data, model) = (1, 2), (2, 1), (2, 2) and (1, 4), for the three
  dense llama-style smoke configs in f32 (``yi-9b-smoke``'s one KV head of 16
  columns splits at model 2 and 4; ``codeqwen1.5-7b-smoke``'s q/k/v biases
  are drawn non-zero) and once with ``seq_parallel=True``: every rank's
  logits, gathered by its coordinates, match ``repro.models.model.prefill``
  + ``decode_step`` on the same numpy params to ``rtol=atol=1e-5``, the
  greedy tokens are equal, and each rank's cache (every KV head, its batch
  rows) matches the JAX cache. Two groups are spawned for the whole file
  (two ranks, then four), each running every case.
* Counts: each rank's ``CollectiveCounter`` totals on the gloo group equal
  the ``meta`` count of the same drive over a ``fake`` group of the mesh's
  size, kind by kind, and a formula written here from the config's widths.
* The dry run reads the partitioned program's collectives for the three
  archs at ``decode_32k`` and ``prefill_32k``, and for gemma2-27b,
  internvl2-2b and seamless-m4t-large-v2 at those and ``train_4k``, on both
  production meshes (``"program"``), the specs' model elsewhere
  (``"specs"``: MoE, zamba2-7b, rwkv6-1.6b, every ``long_500k`` cell).
* B4's head window: the plain version over a view ``cache[:, j0:j1]`` equals
  the whole cache's result for those heads, and the op reports the window's
  work; on the card (``cuda`` marker, skipped without one) the kernel over
  such a view equals its plain version, leaving the view unmoved.
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
from repro_torch.kernels.decode_attention import ref as tref  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention_op  # noqa: E402
from repro_torch.kernels.work import attn_work  # noqa: E402
from repro_torch.launch import costrun, dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import partitioned  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ARCHS = ["llama3-8b", "yi-9b", "codeqwen1.5-7b"]
CASES = ARCHS + ["llama3-8b+sp"]          # the last with seq_parallel=True
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4)]}   # world size -> meshes
B, S, STEPS, MAX_LEN = 4, 16, 6, 32
TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(case):
    arch = case.split("+")[0]
    jcfg = get_config(arch, smoke=True).replace(dtype="float32", param_dtype="float32")
    tcfg = ModelConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    return jcfg, tcfg.replace(seq_parallel=case.endswith("+sp"))


def _jax_params(jcfg):
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    if jcfg.qkv_bias:   # JAX inits them to zeros: draw them, so the test sees them
        r = np.random.default_rng(9)
        attn = dict(jp["layers"]["attn"])
        for k in ("bq", "bk", "bv"):
            attn[k] = jnp.asarray((r.standard_normal(attn[k].shape) * 0.5).astype(np.float32))
        jp = {**jp, "layers": {**jp["layers"], "attn": attn}}
    return jp


def _prompts(jcfg):
    return np.random.default_rng(4).integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's unsharded prefill + greedy decode steps per arch
    (jitted, as the JAX engine runs them): (numpy params, prompts, logits a
    step, tokens (B, STEPS + 1), cache k/v)."""
    out = {}
    for arch in ARCHS:
        jcfg, _ = _configs(arch)
        jp = _jax_params(jcfg)
        toks = _prompts(jcfg)
        prefill = jax.jit(lambda p, t, c=jcfg: JM.prefill(p, {"tokens": t}, c, max_len=MAX_LEN))
        step = jax.jit(lambda p, cache, t, c=jcfg: JM.decode_step(p, cache, t, c))
        logits, cache = prefill(jp, jnp.asarray(toks))
        outs, greedy = [np.asarray(logits)], [np.asarray(logits)[:, -1].argmax(-1)[:, None]]
        for _ in range(STEPS):
            logits, cache = step(jp, cache, jnp.asarray(greedy[-1], jnp.int32))
            outs.append(np.asarray(logits))
            greedy.append(np.asarray(logits)[:, -1].argmax(-1)[:, None])
        out[arch] = (jax.tree_util.tree_map(np.asarray, jp), toks, outs,
                     np.concatenate(greedy, axis=1), np.asarray(cache["k"]),
                     np.asarray(cache["v"]))
    return out


@pytest.fixture(scope="module")
def groups(jax_runs):
    """Every case on every mesh: one two-rank and one four-rank gloo group,
    each rank's results by world size (rank order)."""
    jobs = []
    for case in CASES:
        arch = case.split("+")[0]
        params, toks = jax_runs[arch][:2]
        jobs.append((_configs(case)[1], params, toks))
    return {world: tmesh.spawn(partitioned.rank_run, world, jobs, meshes, MAX_LEN, STEPS, "cpu")
            for world, meshes in MESHES.items()}


def _case_mesh():
    return [(case, shape) for case in CASES for shape in (*MESHES[2], *MESHES[4])]


def _ranks(groups, case, shape):
    world = shape[0] * shape[1]
    mi = MESHES[world].index(shape)
    return [r[CASES.index(case)][mi] for r in groups[world]]


@pytest.mark.parametrize("case,shape", _case_mesh())
def test_partitioned_program_matches_jax(groups, jax_runs, case, shape):
    """Logits gathered by coordinates, greedy tokens and every rank's cache
    rows against the JAX unsharded run."""
    jlogits, jgreedy, jk, jv = jax_runs[case.split("+")[0]][2:]
    ranks = _ranks(groups, case, shape)
    nd, nm = shape
    rows = B // nd
    v = jlogits[0].shape[-1]
    got = [np.full_like(x, np.nan) for x in jlogits]
    for r in ranks:
        di, mi = r["coords"]["data"], r["coords"]["model"]
        rs = slice(di * rows, (di + 1) * rows)
        cols = slice(mi * v // nm, (mi + 1) * v // nm)
        assert r["logits"][0].shape == (rows, 1, v // nm)
        for g, x in zip(got, r["logits"]):
            g[rs, :, cols] = x
        np.testing.assert_array_equal(r["tokens"], jgreedy[rs])
        np.testing.assert_allclose(r["k"], jk[:, rs], **TOL)
        np.testing.assert_allclose(r["v"], jv[:, rs], **TOL)
    for g, want in zip(got, jlogits):
        np.testing.assert_allclose(g, want, **TOL)


def _formula(cfg, shape) -> dict:
    """Per-rank collectives of the drive from the config's widths (f32): per
    forward of T tokens over b rows, the embedding's all-reduce; a layer's
    K/V all-gather (2·b·T·Hkv·hd) and two block reductions (all-reduces, or
    under sequence parallelism reduce-scatters of b·T/n·d with all-gathers
    of the normed inputs and of the final hidden states); the greedy gather
    of each row's last f32 logits."""
    nd, nm = shape
    if nm == 1:
        return {"_counts": {}}
    b, d, n_l, a = B // nd, cfg.d_model, cfg.n_layers, 4
    kv = 2 * cfg.n_kv_heads * cfg.head_dim
    out = {"all-reduce": 0.0, "all-gather": 0.0, "reduce-scatter": 0.0}
    calls = dict.fromkeys(out, 0)

    def add(kind, n, nbytes):
        calls[kind] += n
        out[kind] += n * nbytes * (2 if kind == "all-reduce" else 1)

    for t in [S] + [1] * STEPS:
        add("all-reduce", 1, b * t * d * a)
        add("all-gather", n_l, b * t * kv * a)
        if cfg.seq_parallel and t >= 16:
            add("reduce-scatter", 2 * n_l, b * t // nm * d * a)
            add("all-gather", 2 * n_l + 1, b * t * d * a)
        else:
            add("all-reduce", 2 * n_l, b * t * d * a)
        add("all-gather", 1, b * cfg.vocab_size * 4)
    res = {k: v for k, v in out.items() if calls[k]}
    res["_counts"] = {k: v for k, v in calls.items() if v}
    return res


@pytest.mark.parametrize("shape", [*MESHES[2], *MESHES[4]])
def test_collective_counts_meta_equal_gloo(groups, shape):
    """Kind by kind: every gloo rank's count = the meta count over a fake
    group = the formula."""
    for case in CASES:
        cfg = _configs(case)[1]
        meta = partitioned.count_run(cfg, shape, B, S, MAX_LEN, STEPS)
        assert meta == _formula(cfg, shape), case
        for r in _ranks(groups, case, shape):
            assert r["collectives"] == meta, (case, r["coords"])
            assert not any(r["launches"].values())   # the CPU runs the plain versions


def test_partitioned_refuses_what_it_does_not_cover():
    cfg = t_get_config("llama3-8b", smoke=True)
    with tmesh.counting_mesh((1, 2), ("data", "model")) as m:
        TM.check_partitioned(cfg, m)
        rings = t_get_config("gemma2-27b", smoke=True).replace(windowed_kv_cache=True)
        for bad in (cfg.replace(quantized_decode=True), rings,
                    t_get_config("olmoe-1b-7b", smoke=True), t_get_config("zamba2-7b", smoke=True),
                    t_get_config("rwkv6-1.6b", smoke=True)):
            with pytest.raises(ValueError):
                TM.check_partitioned(bad, m)
        with pytest.raises(ValueError, match="paged"):
            TM.check_partitioned(cfg, m, {"k_pages": None, "pos": None})
    with tmesh.counting_mesh((1, 8), ("data", "model")) as m:
        with pytest.raises(ValueError, match="query heads"):
            TM.check_partitioned(cfg, m)       # 4 query heads over 8 ranks


FAMILY_ARCHS = ["gemma2-27b", "internvl2-2b", "seamless-m4t-large-v2"]
PROGRAM_CELLS = ([(a, s) for a in ARCHS for s in ("decode_32k", "prefill_32k")]
                 + [(a, s) for a in FAMILY_ARCHS for s in ("decode_32k", "prefill_32k", "train_4k")])


def _train_formula(cfg, multi_pod: bool) -> dict:
    """Rank 0's ``train_4k`` collectives from the widths, as
    ``test_torch_launch_tools.py`` writes llama3-8b's: the rank's 256 / dp
    rows (dp 16, multi-pod 32) in 4 microbatches of b rows, remat on, bf16
    activations (a) of T rows (t tokens; a vlm's stack also its prefix; audio
    t = S frames = 2,048). A microbatch all-reduces (2x each): the embedding
    lookup (t rows) and the head's input gradient; a layer's two block
    reductions forward, their two conjugates backward and the attention's
    again in the recompute (gemma2's post-norms read the MLP's reduced
    output too, so it is recomputed as well: 6); an audio decoder layer adds
    the cross attention's three, the encoder memory's gradient one; the
    loss's three f32 statistics a token in two calls a 1,024-token chunk. A
    step adds two f32 scalars. K/V: an all-gather a self attention layer
    forward and in the recompute, one a cross K/V forward, a reduce-scatter
    (kv / 16 columns) a forward gather backward. ZeRO-1: each leaf's f32
    gradient reduce-scattered over dp, its bf16 update all-gathered (the
    rank's shard whole; the vocab padded to 16)."""
    dp, accum, a = 32 if multi_pod else 16, dryrun.TRAIN_ACCUM, 2
    audio, tied = int(cfg.family == "audio"), cfg.tie_embeddings
    b = 256 // dp // accum
    t = 4096 // 2 if audio else 4096
    big_t = t + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)
    d, n_l, n_e = cfg.d_model, cfg.n_layers, cfg.n_encoder_layers if audio else 0
    kv, hq = cfg.n_kv_heads * cfg.head_dim, cfg.n_heads * cfg.head_dim
    post = 2 if cfg.post_block_norm else 0
    per_layer = 5 + post // 2 + 3 * audio
    reduces = 1 + 5 * n_e + per_layer * n_l + audio        # at T rows, beside the lookup
    chunks = t // 1024
    gathers, scatters = 2 * n_l + 2 * n_e + audio * n_l, n_l + n_e + audio * n_l
    vocab = -(-cfg.vocab_size // 16) * 16
    attn, mlp = d * (2 * hq + 2 * kv), 3 * d * cfg.d_ff
    sharded = vocab * d * (1 if tied else 2) + n_e * (attn + mlp) + n_l * (attn + mlp
                                                                      + audio * attn)
    norms = d * (n_l * (2 + post + audio) + 2 * n_e + 1 + audio)
    shard = sharded // 16 + norms
    leaves = (1 if tied else 2) + 1 + audio + (7 + 2 + post + 5 * audio) + audio * 9
    kv_bytes = 2 * b * big_t * kv * a
    return {"all-reduce": 2.0 * (accum * (b * t * d * a + reduces * b * big_t * d * a)
                                 + accum * b * t * 3 * 4 + 2 * 4),
            "all-gather": accum * gathers * kv_bytes + shard * a,
            "reduce-scatter": accum * scatters * kv_bytes // 16 + shard // dp * 4,
            "_counts": {"all-reduce": accum * (1 + reduces + 2 * chunks) + 2,
                        "all-gather": accum * gathers + leaves,
                        "reduce-scatter": accum * scatters + leaves}}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", PROGRAM_CELLS)
def test_dryrun_counts_the_program(arch, shape, multi_pod):
    """The covered cells read the program. Decode and prefill: the specs'
    all-reduce bytes exactly, one all-reduce a row-parallel product applied
    (the embedding's; each decoder layer's attention, MLP and, audio, cross
    attention; the audio encoder's two a layer in prefill), plus one
    all-gather of b·T·2·Hkv·hd bf16 a K/V projection (each decoder layer's;
    audio prefill also each encoder layer's and each cross K/V of the
    S-frame memory) and, where 16 does not divide the vocab (GSPMD's padded
    vocab), the f32 logits gathered over its padded width. Train: each
    kind's calls and bytes from the widths (:func:`_train_formula`), fewer
    all-reduce bytes than the specs' model (ZeRO-1 reduce-scatters and
    all-gathers in place of the gradient all-reduce)."""
    cfg = t_get_config(arch)
    with tmesh.production_mesh_for_counting(multi_pod=multi_pod) as m:
        coll, source = dryrun.collectives_on(cfg, shape, m)
        specs = dryrun.collective_bytes_from_specs(cfg, shape, m)
    assert source == "program"
    if shape == "train_4k":
        want = _train_formula(cfg, multi_pod)
        assert coll.pop("_counts") == want.pop("_counts")
        assert coll == pytest.approx(want, rel=1e-12)
        assert coll["all-reduce"] < specs["all-reduce"]
        return
    b = 128 // (32 if multi_pod else 16) if shape == "decode_32k" else (1 if multi_pod else 2)
    audio = cfg.family == "audio"
    t = 1 if shape == "decode_32k" or audio else 32768 + cfg.n_prefix_tokens
    kv = 2 * cfg.n_kv_heads * cfg.head_dim * 2
    gathers, nbytes = cfg.n_layers, cfg.n_layers * b * t * kv
    reduces = 1 + 2 * cfg.n_layers + (cfg.n_layers if audio else 0)
    if audio and shape == "prefill_32k":
        gathers += cfg.n_encoder_layers + cfg.n_layers
        nbytes += (cfg.n_encoder_layers + cfg.n_layers) * b * 32768 * kv
        reduces += 2 * cfg.n_encoder_layers
    if cfg.vocab_size % 16:
        gathers += 1
        nbytes += b * 16 * -(-cfg.vocab_size // 16) * 4
    assert coll["_counts"] == {"all-reduce": reduces, "all-gather": gathers}
    assert coll["all-reduce"] == specs["all-reduce"]
    assert coll["all-gather"] == nbytes


def test_dryrun_moe_and_other_cells_stay_specs():
    res = dryrun.run_cell("olmoe-1b-7b", "decode_32k", False)
    assert res["status"] == "ok" and res["collectives_source"] == "specs"
    for arch, shape in (("llama3-8b", "long_500k"), ("zamba2-7b", "train_4k"),
                        ("zamba2-7b", "decode_32k"), ("rwkv6-1.6b", "prefill_32k"),
                        ("rwkv6-1.6b", "long_500k"), ("phi3.5-moe-42b-a6.6b", "train_4k")):
        with tmesh.production_mesh_for_counting() as m:
            assert dryrun.collectives_on(t_get_config(arch), shape, m)[1] == "specs"


# (0, 1, 2): the llama3-8b rank of (16, 16), its 2 query heads over KV head 0
@pytest.mark.parametrize("j0,j1,g", [(1, 2, 4), (2, 4, 2), (0, 1, 2)])
def test_b4_head_window_plain_version(j0, j1, g):
    """A window of KV heads (a view of the lanes, and a partial query group
    of 2 of a KV head's 4, over one head or two) gives the whole cache's result for those heads,
    and the op reports the window's work."""
    gen = torch.Generator().manual_seed(3)
    b, hkv, hd, lmax = 3, 4, 16, 40
    k = torch.randn((b, hkv, hd, lmax), generator=gen)
    v = torch.randn((b, hkv, lmax, hd), generator=gen)
    q = torch.randn((b, hkv, 4, hd), generator=gen)
    end = torch.tensor([40, 17, 1], dtype=torch.int32)
    full = tref.decode_attention_ref(q, k, v, end, 0.25)
    qw = q[:, j0:j1, :g]
    out = tref.decode_attention_ref(qw, k[:, j0:j1], v[:, j0:j1], end, 0.25)
    np.testing.assert_allclose(out.numpy(), full[:, j0:j1, :g].numpy(), rtol=1e-6, atol=1e-6)
    with torch.no_grad(), costrun.CostCounter() as c:
        op = decode_attention_op(qw.reshape(b, -1, hd), k[:, j0:j1], v[:, j0:j1], end,
                                 scale=0.25)
    np.testing.assert_allclose(op.numpy(), out.reshape(b, -1, hd).numpy(), rtol=0, atol=0)
    nbytes, ops = attn_work(b * lmax, b, j1 - j0, g, hd, b * (j1 - j0) * g * hd * 4,
                            kv_bytes=4, q_bytes=4)
    assert c.totals()["kernels"]["decode_attention"] == {"calls": 1, "bytes": nbytes, "ops": ops}


@pytest.mark.cuda
# (0, 1, 2): the llama3-8b rank of (16, 16), its 2 query heads over KV head 0
@pytest.mark.parametrize("j0,j1,g", [(1, 2, 4), (2, 4, 2), (0, 1, 2)])
def test_b4_head_window_on_the_card(j0, j1, g):
    """The kernel over a window of a cache's KV heads (bf16, Lmax 1,000: the
    copy-engine walk and four chunks) equals its plain version on it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.decode_attention import decode_attention as da

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    b, hkv, hd, lmax = 3, 4, 128, 1000
    k = torch.randn((b, hkv, hd, lmax), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, hkv, lmax, hd), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((b, j1 - j0, g, hd), generator=gen, device=dev).to(torch.bfloat16)
    end = torch.tensor([1000, 517, 3], dtype=torch.int32, device=dev)
    kw, vw = k[:, j0:j1], v[:, j0:j1]
    out = da.decode_attention(q, kw, vw, end, scale=hd ** -0.5)
    want = tref.decode_attention_ref(q, kw, vw, end, hd ** -0.5)
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-5)
    assert da._lane_heads(kw, vw) == hkv

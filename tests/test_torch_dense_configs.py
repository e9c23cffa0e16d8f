"""The rest of the dense family in the port against the JAX package, on the
CPU at f32 smoke sizes: yi-9b (GQA, G = 4 at smoke size, 8 at full width)
and codeqwen1.5-7b (MHA, G = 1, with q/k/v biases, drawn non-zero here so
they count).

Every config field equals the JAX one (gemma2-27b too, full and smoke);
``decode_step`` on the paged cache (W8A8 on and off) and ``prefill`` match
``M.decode_step`` / ``M.prefill``; ``Engine.serve`` gives the JAX engine's
tokens, states and events in the three modes; and the serving CLI serves
each of the three archs at smoke size on the CPU.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from test_torch_gemma2 import MODES, TOL, run_jax, run_torch  # noqa: E402
from test_torch_model import paged_cache, t  # noqa: E402

ARCHS = ["yi-9b", "codeqwen1.5-7b"]
PROMPTS = [[(3 * i + 7 * j) % 250 + 1 for j in range(n)] for i, n in enumerate((9, 3, 6, 11))]
BUDGETS = [4, 6, 3, 2]


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS + ["gemma2-27b"])
def test_config_copy_matches_jax(arch, smoke):
    assert arch in list_archs()
    assert dataclasses.asdict(t_get_config(arch, smoke=smoke)) == \
        dataclasses.asdict(get_config(arch, smoke=smoke))


def test_full_width_shapes():
    yi, cq = t_get_config("yi-9b"), t_get_config("codeqwen1.5-7b")
    assert (yi.n_layers, yi.q_per_kv, yi.head_dim, yi.d_ff) == (48, 8, 128, 11008)
    assert (cq.q_per_kv, cq.head_dim, cq.d_ff, cq.qkv_bias) == (1, 128, 13440, True)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg = get_config(request.param, smoke=True).replace(dtype="float32",
                                                          param_dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    if jcfg.qkv_bias:   # JAX inits them to zeros: draw them, so the test sees them
        r = np.random.default_rng(9)
        attn = dict(jp["layers"]["attn"])
        for k in ("bq", "bk", "bv"):
            attn[k] = jnp.asarray((r.standard_normal(attn[k].shape) * 0.5).astype(np.float32))
        jp = {**jp, "layers": {**jp["layers"], "attn": attn}}
    tp = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jp, tp


def test_params_tree_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    fresh = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(fresh) == set(tp) == set(jp)
    assert set(fresh["layers"][0]["attn"]) == set(tp["layers"][0]["attn"])
    assert ("bq" in tp["layers"][0]["attn"]) == jcfg.qkv_bias


@pytest.mark.parametrize("tok", [1, 3])
@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_step_vs_jax(models, tok, quantized):
    jcfg, tcfg, jp, tp = models
    jcfg, tcfg = (c.replace(quantized_decode=quantized) for c in (jcfg, tcfg))
    c = paged_cache(jcfg, b=3, nb=6, bsz=4, pos=[0, 9, 17], seed=tok)
    tokens = np.random.default_rng(8).integers(1, jcfg.vocab_size, (3, tok)).astype(np.int32)
    jlog, jc = JM.decode_step(jp, {k: jnp.asarray(v) for k, v in c.items()},
                              jnp.asarray(tokens), jcfg)
    tc = {k: t(v) for k, v in c.items()}
    tlog, tc2 = TM.decode_step(tp, tc, t(tokens).long(), tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert (tlog.argmax(-1).numpy() == np.asarray(jlog).argmax(-1)).all()
    for k in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tc2[k].numpy(), np.asarray(jc[k]), **TOL)


def test_prefill_vs_jax(models):
    jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(6).integers(1, jcfg.vocab_size, (2, 11)).astype(np.int32)
    jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, max_len=24)
    tl, tc = TM.prefill(tp, t(toks).long(), tcfg, max_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_engine_serve_matches_jax(models, mode):
    jcfg, tcfg, jp, tp = models
    kw = dict(prompts=PROMPTS, budgets=BUDGETS)
    jres, jev, jrep = run_jax(jcfg, jp, mode, False, **kw)
    tres, tev, trep = run_torch(tcfg, tp, mode, False, **kw)
    assert (tres, tev, trep) == (jres, jev, jrep)
    assert all(r[2] == "finished" for r in tres)


@pytest.mark.parametrize("arch", ARCHS + ["gemma2-27b"])
def test_cli_serves_arch(capsys, arch):
    assert cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                     "--prompt-len", "10", "--max-new", "4", "--slots", "2",
                     "--chunk", "4"]) == 0
    out = capsys.readouterr().out
    assert out.count("  req") == 3 and "occupancy: slots 0/2" in out

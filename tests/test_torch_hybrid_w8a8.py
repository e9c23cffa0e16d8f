"""zamba2 smoke serving with W8A8 decode against the JAX package, on the CPU.

The second half of ``test_torch_hybrid.py`` (split to keep each file short):
``decode_step`` and ``Engine.serve`` with ``quantized_decode`` in BLOCKED,
HBCEM and LBIM. Tokens, request states and ``ScheduleEvent`` streams must
equal the JAX engine's.
"""
import pytest

torch = pytest.importorskip("torch")

from serving_refs import BUDGETS, PROMPTS  # noqa: E402
from test_torch_hybrid import (MODES, check_decode_steps, models, run_jax,  # noqa: E402,F401
                               run_torch)


def test_hybrid_w8a8_decode_step_vs_jax(models):
    check_decode_steps(models, quantized=True)


@pytest.mark.parametrize("mode", MODES)
def test_hybrid_w8a8_serve_matches_jax(models, mode):
    jcfg, tcfg, jp, tp = models
    jres, jev, jrep = run_jax(jcfg, jp, mode, PROMPTS, BUDGETS, True)
    tres, tev, trep = run_torch(tcfg, tp, mode, PROMPTS, BUDGETS, True)
    assert tres == jres
    assert tev == jev
    assert trep == jrep
    assert all(r[2] == "finished" for r in tres)

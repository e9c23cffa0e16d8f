"""zamba2 smoke serving against the JAX package, on the CPU at f32.

``Engine.serve`` in BLOCKED, HBCEM and LBIM with W8A8 decode off (on in
``test_torch_hybrid_w8a8.py``), and a ragged set of prompts longer than the
smoke scan chunk: tokens, finish reasons, request states, latency marks and
``ScheduleEvent`` streams must equal the JAX engine's.
"""
import pytest

torch = pytest.importorskip("torch")

from serving_refs import BUDGETS, PROMPTS  # noqa: E402
from test_torch_hybrid import MODES, models, run_jax, run_torch  # noqa: E402,F401

# prompts longer than the smoke scan chunk (8) and ragged, so batch admission
# goes one request at a time and chunked admission spans several scan chunks
LONG_PROMPTS = [[(7 * i + 3 * j) % 250 + 1 for j in range(n)]
                for i, n in enumerate((13, 5, 21, 9, 17))]
LONG_BUDGETS = [3, 6, 2, 5, 4]


@pytest.mark.parametrize("mode", MODES)
def test_hybrid_serve_matches_jax(models, mode):
    jcfg, tcfg, jp, tp = models
    jres, jev, jrep = run_jax(jcfg, jp, mode, PROMPTS, BUDGETS, False)
    tres, tev, trep = run_torch(tcfg, tp, mode, PROMPTS, BUDGETS, False)
    assert tres == jres
    assert tev == jev
    assert trep == jrep
    assert all(r[2] == "finished" for r in tres)


def test_hybrid_serve_long_ragged_prompts_match_jax(models):
    """Batch admission of ragged prompts one request per group (events
    included), and chunked admission over several scan chunks, in LBIM."""
    jcfg, tcfg, jp, tp = models
    jres, jev, jrep = run_jax(jcfg, jp, "LBIM", LONG_PROMPTS, LONG_BUDGETS, False)
    tres, tev, trep = run_torch(tcfg, tp, "LBIM", LONG_PROMPTS, LONG_BUDGETS, False)
    assert (tres, tev, trep) == (jres, jev, jrep)
    assert sum(1 for e in tev if not e[1] and e[2]) >= 2   # per-request batch events

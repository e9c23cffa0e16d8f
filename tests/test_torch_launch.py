"""The port's serving CLI (``repro_torch.launch.serve``) in-process on the CPU
(``--device cpu --smoke``): the traffic flags (``--arrival-rate``, ``--trace``
replay, ``--mode-policy auto``), fault plans (``--faults``) and deadlines
drive the ported engine, and every run prints its tokens, the latency summary
and the health line with occupancy, as the JAX package's CLI does. The
training CLI (``repro_torch.launch.train``) prints the JAX training CLI's
final line and resumes from its checkpoints."""
import ast
import os
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.serve import traffic  # noqa: E402
from repro_torch.serve.faults import FaultPlan  # noqa: E402

BASE = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--requests", "5",
        "--prompt-len", "10", "--max-new", "5", "--slots", "2", "--chunk", "4"]


def _run(capsys, *extra) -> str:
    assert cli.main(BASE + list(extra)) == 0
    return capsys.readouterr().out


def _health(out: str) -> tuple[bool, dict]:
    m = re.search(r"^health: degraded=(True|False) counters=(\{.*\})$", out, re.M)
    assert m, out
    return m.group(1) == "True", ast.literal_eval(m.group(2))


def _tokens(out: str) -> list[str]:
    return re.findall(r"^  req\d+ \(.*$", out, re.M)


def test_arrivals_auto_policy_and_faults(capsys):
    out = _run(capsys, "--arrival-rate", "0.3", "--mode-policy", "auto", "--faults", "1",
               "--ttft-deadline", "60", "--seed", "3")
    assert "traffic: poisson rate=0.3/step seed=3 (5 requests)" in out
    assert re.search(r"^latency \(steps\): ttft p50=\d+ .* queue-wait p50=\d+", out, re.M)
    assert re.search(r"^SLO attainment: \d+/5 ", out, re.M)
    assert len(_tokens(out)) == 3
    degraded, counters = _health(out)
    # on the CPU no kernel is live: the plan's kernel faults stay pending, the
    # slow steps fire, and nothing fails
    plan = FaultPlan.seeded(1)
    fired = sum(f.kind in ("alloc_fail", "slow_step") for f in plan.faults)
    assert not degraded
    assert counters["injected_faults"] == fired > 0
    assert counters["failures"] == counters["retried_steps"] == 0
    assert re.search(r"^occupancy: slots 0/2 pages \d+/\d+ prefix_pins=0$", out, re.M)
    assert re.search(r"^ladder: .*'backend': 'reference'.* fault_plan: ", out, re.M)
    assert "mode_steps={'" in out and "'lbim'" in out


def test_trace_replay_equals_generated_arrivals(capsys, tmp_path):
    gen = _run(capsys, "--arrival-rate", "0.5", "--seed", "2", "--mode", "lbim")
    trace = traffic.generate(traffic.TrafficConfig(
        n_requests=5, seed=2, rate=0.5, prompt_len=(10, 10), max_new=(5, 5), vocab=256))
    path = tmp_path / "trace.json"
    trace.save(path)
    rep = _run(capsys, "--trace", str(path), "--mode", "lbim")
    assert f"traffic: replaying 5 requests from {path}" in rep
    assert _tokens(rep) == _tokens(gen)
    assert _health(rep) == _health(gen)


def test_deadline_times_out_and_health_counts_it(capsys):
    out = _run(capsys, "--ttft-deadline", "1", "--mode", "blocked")
    _, counters = _health(out)
    assert counters["timeouts"] >= 1
    assert "timed_out" in out


def test_cli_serves_rwkv6_and_seamless_fails_at_admission(capsys):
    """No arch of the JAX package is refused any more: rwkv6 (ROADMAP A.9's
    last refusal here) serves through the CLI, and seamless-m4t-large-v2
    fails at admission, as the JAX CLI does (``KeyError: 'src_frames'``
    there)."""
    assert cli.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu", "--requests", "3",
                     "--prompt-len", "10", "--max-new", "4", "--slots", "2",
                     "--chunk", "4"]) == 0
    out = capsys.readouterr().out
    assert "prepared rwkv6-1.6b-smoke: device=cpu prequantized=False" in out
    assert out.count("  req") == 3 and "occupancy: slots 0/2 pages 0/0" in out
    with pytest.raises(ValueError, match="src_frames"):
        cli.main(["--arch", "seamless-m4t-large-v2", "--smoke", "--device", "cpu",
                  "--requests", "2", "--prompt-len", "6", "--max-new", "2"])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"])
def test_cli_serves_the_moe_family(capsys, arch):
    """The MoE family is served, as rwkv6 (above) and every other arch."""
    assert cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                     "--prompt-len", "10", "--max-new", "4", "--slots", "2",
                     "--chunk", "4"]) == 0
    out = capsys.readouterr().out
    assert out.count("  req") == 3 and "occupancy: slots 0/2" in out


def test_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.parse_args(["--arch", "llama3-8b"]).device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--arch", "llama3-8b", "--smoke"])


def test_train_cli_on_the_cpu(capsys, tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu --steps 3``
    prints the JAX CLI's final line; rerun over its checkpoint directory it
    resumes at the saved step and has nothing left to run past it."""
    from repro_torch.launch import train as train_cli

    argv = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--steps", "3",
            "--ckpt-dir", str(tmp_path)]
    assert train_cli.main(argv) == 0
    out = capsys.readouterr().out
    m = re.search(r"^final loss (\d+\.\d{4}) \(start (\d+\.\d{4})\) over 3 steps$", out, re.M)
    assert m, out
    assert os.path.isdir(tmp_path / "step_00000003")
    assert train_cli.main(argv[:-2] + ["--steps", "4", "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[resume] restored step 3, continuing at 3" in out and "over 1 steps" in out


def test_train_device_defaults_to_cuda(monkeypatch):
    from repro_torch.launch import train as train_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train_cli.parse_args(["--arch", "llama3-8b"]).device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "llama3-8b", "--smoke", "--steps", "1"])


def test_cli_registry_equals_jax_and_serves_internvl2(capsys):
    """The CLI refuses no arch: its registry is the JAX package's, the A.9
    families included. internvl2-2b serves W8A8 on the paged pool (its
    requests carry no image, as in the JAX engine); every arch's config is
    what ``--arch`` resolves."""
    from repro.configs import list_archs as j_list_archs
    from repro_torch.configs import get_config, list_archs

    assert not hasattr(cli, "_UNPORTED_ARCHS")
    assert list_archs() == sorted(j_list_archs())
    assert {"rwkv6-1.6b", "internvl2-2b", "seamless-m4t-large-v2"} <= set(list_archs())
    assert cli.main(["--arch", "internvl2-2b", "--smoke", "--device", "cpu", "--requests", "3",
                     "--prompt-len", "10", "--max-new", "4", "--slots", "2", "--chunk", "4",
                     "--quantized-decode"]) == 0
    out = capsys.readouterr().out
    assert "prepared internvl2-2b-smoke: device=cpu prequantized=True" in out
    assert out.count("  req") == 3 and "occupancy: slots 0/2" in out
    assert get_config("internvl2-2b", smoke=True).family == "vlm"

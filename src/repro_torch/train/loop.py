"""The training loop with fault tolerance (port of ``repro.train.loop``):
auto-resume from the newest valid checkpoint, periodic async saves (one in
flight at a time) and a final save.

The loop owns one params tree and one optimizer state and steps them in
place through ``train_step.TrainGraphs``: a captured graph replayed on the
card, the same step run eagerly on the CPU. It gives the functional step's
bits (``train_step``, the JAX loop's form, which the tests hold it to). A
checkpoint snapshots to the host before the next step runs."""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train import checkpoint
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import AdamWConfig, init_opt_state, tree_map
from repro_torch.train.train_step import TrainGraphs


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: str = ""
    ckpt_every: int = 50
    log_every: int = 10
    accum: int = 1
    seed: int = 0
    opt: AdamWConfig = field(default_factory=AdamWConfig)


def run(cfg: ModelConfig, data_cfg: DataConfig, tcfg: TrainConfig, params=None, log=print,
        device=None):
    """Returns (params, opt_state, history). Resumes from ``tcfg.ckpt_dir``.

    The run takes place on ``device`` (None: CUDA, which raises without a
    card), where ``params`` must live; without ``params`` the weights are
    drawn there from a ``torch.Generator`` seeded with ``tcfg.seed``. Each
    ``history`` entry is {step, loss, dt}: ``dt`` the step's host seconds,
    ending in a device sync on CUDA. A non-finite loss raises
    ``FloatingPointError``. Every step is written into the loop's own
    params and state: a given ``params`` tree is copied once and never
    written."""
    dev = resolve_device(device)
    graphs = TrainGraphs(dev)
    if params is None:
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(tcfg.seed),
                               device=dev)
    else:
        params = tree_map(torch.clone, params)
    opt_state = init_opt_state(params)
    start = 0
    if tcfg.ckpt_dir:
        latest = checkpoint.latest_step(tcfg.ckpt_dir)
        if latest is not None:
            params, opt_state, extra = checkpoint.restore(
                tcfg.ckpt_dir, latest, params, opt_state)
            start = int(extra.get("next_step", latest))
            log(f"[resume] restored step {latest}, continuing at {start}")

    data = SyntheticLM(data_cfg)
    history = []
    pending = None
    for step in range(start, tcfg.steps):
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(step).items()}
        t0 = time.perf_counter()
        # the batch goes to the graph's buffers from the host
        metrics = graphs.step(params, opt_state, batch, cfg, tcfg.opt, tcfg.accum)
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss at step {step}")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        history.append({"step": step, "loss": loss,
                        "dt": time.perf_counter() - t0})
        if tcfg.log_every and step % tcfg.log_every == 0:
            log(f"step {step:5d} loss {loss:.4f} "
                f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.2f}")
        if tcfg.ckpt_dir and (step + 1) % tcfg.ckpt_every == 0:
            if pending is not None:
                pending.join()  # one in flight at a time
            pending = checkpoint.save(tcfg.ckpt_dir, step + 1, params, opt_state,
                                      extra={"next_step": step + 1}, async_=True)
    if pending is not None:
        pending.join()
    if tcfg.ckpt_dir:
        checkpoint.save(tcfg.ckpt_dir, tcfg.steps, params, opt_state,
                        extra={"next_step": tcfg.steps})
    return params, opt_state, history

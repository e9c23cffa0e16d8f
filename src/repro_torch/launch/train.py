"""Training launcher of the port: ``python -m repro_torch.launch.train --arch
llama3-8b --smoke`` on the card (``--device cuda``, the default) or
``--device cpu``.

It takes every flag of ``repro.launch.train``. Checkpoints auto-resume from
``--ckpt-dir`` (``repro_torch.train.checkpoint``) and batches are a pure
function of the step, so a run stopped at any point replays exactly. The
last line is the JAX CLI's: the final loss beside the first.

``main(argv)`` runs in-process and returns 0.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import TrainConfig, run
from repro_torch.train.optimizer import AdamWConfig


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    global_batch=args.global_batch)
    tc = TrainConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        accum=args.accum,
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                        total_steps=args.steps),
    )
    _, _, hist = run(cfg, dc, tc, device=args.device)
    print(f"final loss {hist[-1]['loss']:.4f} "
          f"(start {hist[0]['loss']:.4f}) over {len(hist)} steps")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

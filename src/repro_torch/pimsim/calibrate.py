"""Calibration procedure for the CD-PIM performance model.

Run: ``PYTHONPATH=src python -m repro_torch.pimsim.calibrate``

The simulator has physical structure (bandwidths, FLOP counts, Pbank/CU
throughput — none of which are fitted) plus a small set of processor-side
efficiency constants that the paper does not disclose. Those are FITTED to a
subset of the paper's reported numbers and then VALIDATED against the rest
(tests/test_pimsim.py enforces the validation set stays in tolerance):

FITTED (anchors):
  * Jetson ``gpu_bw_eff``=0.84, ``aux_base``=0.2 ms, ``aux_per_layer``=59 µs
    → LLaMA-1B (128,2048) Jetson: GPU-only 35.7 s, CD-PIM 3.53 s,
      decode-latency reduction 90.2 %.
  * ``aux_width_power``(Jetson)=1.37 → LLaMA-7B/13B Jetson HBCEM maxima
    (13.74× / 14.6×).
  * iPhone ``aux_per_layer``=97.6 µs → LLaMA-1B (128,2048) iPhone 18.6×.
  * ``aux_width_power``(iPhone)=2.70 → paper's global HBCEM-vs-GPU average
    11.42×.
  * AttAcc effective BG-bus width 21 B/cycle → paper's 4.25× CD-PIM-vs-AttAcc
    average.

HELD OUT (validation — the model was not tuned on these):
  * decode-latency reduction 90.2 % (falls out of the two e2e anchors),
  * LLaMA-1B Jetson HBCEM max 10.51×,
  * LBIM-vs-HBCEM global average 1.12× and every per-model LBIM range/shape
    (monotone for 1B on Jetson, peak-then-decline for 7B/13B, iPhone < Jetson,
    all ≥ 1.0),
  * LBIM iPhone 1B max 1.23×.

KNOWN DEVIATION: the paper's per-model HBCEM *minimum* speedups (4.48/6.71/
7.47 on Jetson) depend on the figure's undisclosed (Lin,Lout) grid; our grid
{128,2048}² reproduces the maxima and anchors, but our 1B minimum (≈6.6×) is
above the paper's 4.48× — reproducing that exact endpoint requires a
compute-heavier combo (e.g. Lout≈32) that would then misplace the 7B/13B
minima. Recorded in EXPERIMENTS.md.
"""
from __future__ import annotations

import statistics

from repro_torch.pimsim.device import IPHONE, JETSON
from repro_torch.pimsim.latency import gpu_only_e2e, hbcem_e2e
from repro_torch.pimsim.llm import LLAMA_1B, LLAMA_7B, LLAMA_13B, MODELS
from repro_torch.pimsim.pim import ATTACC, CDPIM
from repro_torch.pimsim.scheduler import lbim_e2e

COMBOS = [(128, 128), (128, 2048), (2048, 128), (2048, 2048)]
LBIM_LOUTS = (2, 8, 32, 128)


def report() -> dict:
    out = {}
    g = gpu_only_e2e(LLAMA_1B, 128, 2048, JETSON)
    h = hbcem_e2e(LLAMA_1B, 128, 2048, JETSON, CDPIM)
    out["anchor_gpu_e2e_s"] = (g.total, 35.7)
    out["anchor_pim_e2e_s"] = (h.total, 3.53)
    out["anchor_decode_reduction"] = (1 - h.decode_s / g.decode_s, 0.902)
    out["anchor_speedup_128_2048"] = (g.total / h.total, 10.1)
    gi = gpu_only_e2e(LLAMA_1B, 128, 2048, IPHONE)
    hi = hbcem_e2e(LLAMA_1B, 128, 2048, IPHONE, CDPIM)
    out["anchor_iphone_speedup"] = (gi.total / hi.total, 18.6)

    for m, mx in [(LLAMA_1B, 10.51), (LLAMA_7B, 13.74), (LLAMA_13B, 14.6)]:
        sps = [gpu_only_e2e(m, li, lo, JETSON).total
               / hbcem_e2e(m, li, lo, JETSON, CDPIM).total for li, lo in COMBOS]
        out[f"jetson_{m.name}_max"] = (max(sps), mx)

    sp_gpu, sp_att = [], []
    for dev in (JETSON, IPHONE):
        for m in MODELS.values():
            for li, lo in COMBOS:
                c = hbcem_e2e(m, li, lo, dev, CDPIM).total
                sp_gpu.append(gpu_only_e2e(m, li, lo, dev).total / c)
                sp_att.append(hbcem_e2e(m, li, lo, dev, ATTACC).total / c)
    out["avg_vs_gpu"] = (statistics.mean(sp_gpu), 11.42)
    out["avg_vs_attacc"] = (statistics.mean(sp_att), 4.25)

    lb = []
    for dev in (JETSON, IPHONE):
        for m in MODELS.values():
            for lo in LBIM_LOUTS:
                hb = hbcem_e2e(m, 2048, lo, dev, CDPIM, batch=4).total
                lbt = lbim_e2e(m, 2048, lo, dev, CDPIM, batch=4).total
                lb.append(hb / lbt)
    out["avg_lbim_vs_hbcem"] = (statistics.mean(lb), 1.12)
    out["lbim_never_slower"] = (min(lb), 1.0)
    return out


def main() -> None:
    print(f"{'metric':34s} {'model':>10s} {'paper':>8s} {'err%':>7s}")
    for k, (ours, paper) in report().items():
        err = (ours / paper - 1) * 100
        print(f"{k:34s} {ours:10.3f} {paper:8.3f} {err:+6.1f}%")


if __name__ == "__main__":
    main()

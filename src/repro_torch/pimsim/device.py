"""Edge-device specs (paper Table I) + calibrated efficiency constants.

The two evaluation platforms, exactly as in §IV-A:

* NVIDIA Jetson AGX Orin 64 GB — LPDDR5, 42.5 TFLOPS, 204.8 GB/s, 16 dies
* Apple iPhone 15 Pro          — LPDDR5,  4.29 TFLOPS,  51.2 GB/s,  4 dies

Each LPDDR5 die: 16 data pins @ 6.4 Gbps (12.8 GB/s external per die),
16 banks, 200 MHz internal memory clock, 32 B per bank column access.

Calibration constants (``gpu_bw_eff``, ``gpu_compute_eff``, ``aux_*``) are
fitted by ``repro_torch.pimsim.calibrate`` against the paper's anchor case
(LLaMA-1B, (Lin,Lout)=(128,2048) on Jetson: GPU-only 35.7 s end-to-end,
CD-PIM 3.53 s, decode latency −90.2%) and then *validated* against the other
reported numbers the fit never saw (fig5/6/7 ranges) in tests/test_pimsim.py.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    tflops: float           # processor peak half-precision TFLOPS (Table I)
    ext_bw_gbs: float       # external memory bandwidth GB/s (Table I)
    n_dies: int             # LPDDR5 dies
    banks_per_die: int = 16
    internal_clock_hz: float = 200e6
    bank_access_bytes: int = 32   # per-bank column access per internal cycle

    # ---- calibrated processor-efficiency constants ----
    gpu_compute_eff: float = 0.85   # achievable fraction of peak in GEMM
    gpu_bw_eff: float = 0.75        # achievable fraction of peak ext. bandwidth
    # per-decode-token non-GEMV processor time (softmax, norms, RoPE, sampling,
    # kernel launches): aux_base + n_layers * aux_per_layer * (d/2048)^width_power
    aux_base_s: float = 1e-4
    aux_per_layer_s: float = 5e-5
    aux_width_power: float = 1.37

    @property
    def total_banks(self) -> int:
        return self.n_dies * self.banks_per_die

    @property
    def ext_bw(self) -> float:  # bytes/s
        return self.ext_bw_gbs * 1e9

    @property
    def flops(self) -> float:
        return self.tflops * 1e12


# Calibrated values are produced by `python -m repro_torch.pimsim.calibrate`
# (procedure + which numbers were fitted vs held out documented there).
JETSON = DeviceSpec(
    name="jetson-agx-orin-64gb",
    tflops=42.5,
    ext_bw_gbs=204.8,
    n_dies=16,
    gpu_compute_eff=0.85,
    gpu_bw_eff=0.84,
    aux_base_s=2.0e-4,
    aux_per_layer_s=5.9e-5,
    aux_width_power=1.37,
)

IPHONE = DeviceSpec(
    name="iphone-15-pro",
    tflops=4.29,
    ext_bw_gbs=51.2,
    n_dies=4,
    gpu_compute_eff=0.85,
    gpu_bw_eff=0.84,
    aux_base_s=4.0e-4,
    aux_per_layer_s=9.76e-5,
    aux_width_power=2.70,
)

DEVICES = {d.name: d for d in (JETSON, IPHONE)}

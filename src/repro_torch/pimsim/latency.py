"""Stage latency models: GPU prefill/decode, PIM GEMV decode, aux ops.

Precision (paper §III): PIM runs INT8 weights + activations; the GPU-only
baseline runs FP16 weights with INT8 KV cache (standard llama.cpp-class edge
deployment). Aux = per-decode-token processor-side non-GEMV work (softmax,
norms, RoPE, sampling, launch/sync). Its per-layer term grows super-linearly
with width (fitted power law — partial-sum reduction and vector-op traffic
grow with d_model); calibrated in ``repro_torch.pimsim.calibrate`` against the
paper's anchors and validated against numbers the fit never saw.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.pimsim.device import DeviceSpec
from repro_torch.pimsim.llm import LLMSpec
from repro_torch.pimsim.pim import PIMDesign

GPU_WEIGHT_BYTES = 2  # fp16 baseline weights
GPU_KV_BYTES = 2      # fp16 KV cache on GPU baseline
PIM_BYTES = 1         # int8 weights + activations on PIM
AUX_REF_WIDTH = 2048.0
# per-sequence vector work does not amortize across the batch:
AUX_BATCH_POWER = 1.0
# split-KV flash decoding: each extra KV split adds one partial
# (out, m, l) round-trip + processor-side merge per head group
SPLIT_MERGE_OVERHEAD_S = 2e-6


def aux_time(dev: DeviceSpec, model: LLMSpec, batch: int = 1) -> float:
    per_layer = dev.aux_per_layer_s * (model.d_model / AUX_REF_WIDTH) ** dev.aux_width_power
    t = dev.aux_base_s + model.n_layers * per_layer
    return t * batch**AUX_BATCH_POWER


def gpu_prefill_time(model: LLMSpec, lin: int, dev: DeviceSpec, batch: int = 1,
                     bw_fraction: float = 1.0) -> float:
    """One request's prompt pass on the processor (compute roofline)."""
    t_c = batch * model.prefill_flops(lin) / (dev.flops * dev.gpu_compute_eff)
    t_m = model.prefill_bytes(lin, GPU_WEIGHT_BYTES) / (
        dev.ext_bw * dev.gpu_bw_eff * bw_fraction)
    return max(t_c, t_m)


def gpu_decode_step_time(model: LLMSpec, context: int, dev: DeviceSpec, batch: int = 1) -> float:
    """One decode step for `batch` sequences on the processor (weights shared)."""
    w = model.decode_linear_bytes(GPU_WEIGHT_BYTES)
    kv = model.decode_kv_bytes(context, GPU_KV_BYTES) * batch
    t_m = (w + kv) / (dev.ext_bw * dev.gpu_bw_eff)
    t_c = 2.0 * model.decode_macs(context) * batch / (dev.flops * dev.gpu_compute_eff)
    return max(t_m, t_c) + aux_time(dev, model, batch)


def pim_decode_step_time(model: LLMSpec, context: int, dev: DeviceSpec, design: PIMDesign,
                         batch: int = 1, lbim: bool = False,
                         kv_splits: int = 1) -> float:
    """One decode step for `batch` sequences on PIM.

    PIM has no weight reuse across the batch — every sequence's GEMV streams
    the weights again (reading IS the compute). This is exactly why PIM wins
    at LOW batch and the paper targets edge, not cloud.

    ``kv_splits`` prices split-KV flash decoding: the KV sweep fans out over
    that many page-table splits streamed by parallel Pbank groups (the paged
    analogue of HBCEM's pseudo-bank split), at the cost of one partial
    (out, m, l) merge per extra split. Splits beat a single pass only once
    the KV term dominates the merge overhead — i.e. at long context.
    """
    lin_bytes = model.decode_linear_bytes(PIM_BYTES) * batch
    kv_bytes = model.decode_kv_bytes(context, PIM_BYTES) * batch
    t_lin = lin_bytes / design.gemv_bytes_per_s(dev, lbim)
    t_kv = kv_bytes / design.attn_gemv_bytes_per_s(dev, lbim)
    eff = max(1, min(int(kv_splits), max(int(context), 1)))
    if eff > 1:
        t_kv = t_kv / eff + (eff - 1) * SPLIT_MERGE_OVERHEAD_S
    t_io = model.decode_io_bytes() * batch / dev.ext_bw
    return t_lin + t_kv + t_io + aux_time(dev, model, batch)


def verify_step_time(model: LLMSpec, n_tokens: int, context: int,
                     dev: DeviceSpec, batch: int = 1) -> float:
    """One speculative VERIFY pass: the target scores ``n_tokens`` candidate
    positions per sequence in a single batched forward on the processor.

    This is GEMM-shaped work, not GEMV: the weights stream ONCE for all
    ``n_tokens x batch`` positions (vs one full weight stream per token on
    the PIM decode path) — the entire reason draft/verify pays on a
    bandwidth-bound device. Roofline: compute is the decode MACs of each
    scored position; memory is one weight read plus each sequence's KV sweep.
    """
    n = max(int(n_tokens), 1)
    t_c = (2.0 * model.decode_macs(context) * n * batch
           / (dev.flops * dev.gpu_compute_eff))
    t_m = (model.decode_linear_bytes(GPU_WEIGHT_BYTES)
           + model.decode_kv_bytes(context, GPU_KV_BYTES) * batch) / (
        dev.ext_bw * dev.gpu_bw_eff)
    return max(t_c, t_m) + aux_time(dev, model, batch)


@dataclass
class StageBreakdown:
    prefill_s: float
    decode_s: float

    @property
    def total(self) -> float:
        return self.prefill_s + self.decode_s

    @property
    def ttft_fraction(self) -> float:
        return self.prefill_s / max(self.total, 1e-12)


def gpu_only_e2e(model: LLMSpec, lin: int, lout: int, dev: DeviceSpec,
                 batch: int = 1) -> StageBreakdown:
    """All stages on the processor; prefills sequential, decodes batched."""
    p = batch * gpu_prefill_time(model, lin, dev)
    d = sum(gpu_decode_step_time(model, lin + t, dev, batch) for t in range(lout))
    return StageBreakdown(p, d)


def hbcem_e2e(model: LLMSpec, lin: int, lout: int, dev: DeviceSpec, design: PIMDesign,
              batch: int = 1) -> StageBreakdown:
    """Blocked mode: prefills on processor, then PIM_MAC_FM decode (4 Pbanks)."""
    p = batch * gpu_prefill_time(model, lin, dev)
    d = sum(pim_decode_step_time(model, lin + t, dev, design, batch) for t in range(lout))
    return StageBreakdown(p, d)

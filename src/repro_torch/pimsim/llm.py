"""LLaMA model specs (the paper's workloads) + per-stage FLOP/byte accounting.

The paper evaluates LLaMA-1B/7B/13B with INT8 weights *and* activations on
PIM (§III: "both the input and weight data ... 8-bit precision"); the
GPU-only baseline runs FP16 ([36] LLaMA). Decode is GEMV-dominated:

  per token   linear weights     : N_linear bytes (all projections + FFN)
  per token   KV-cache GEMVs     : 2 · n_layers · d_model · L bytes
  per token   non-GEMV (aux)     : softmax, norms, RoPE, sampling → processor
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LLMSpec:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int = 32000

    @property
    def linear_params(self) -> int:
        """Per-layer projection params × layers (excludes embeddings)."""
        attn = 4 * self.d_model * self.d_model
        ffn = 3 * self.d_model * self.d_ff
        return self.n_layers * (attn + ffn)

    @property
    def total_params(self) -> int:
        return self.linear_params + 2 * self.vocab * self.d_model

    # ---- decode (per token, per sequence) --------------------------------
    def decode_linear_bytes(self, wbytes: int = 1) -> int:
        """Weight bytes streamed per generated token (+ lm_head)."""
        return (self.linear_params + self.vocab * self.d_model) * wbytes

    def decode_kv_bytes(self, context_len: int, kvbytes: int = 1) -> int:
        return 2 * self.n_layers * self.d_model * context_len * kvbytes

    def decode_macs(self, context_len: int) -> int:
        return self.decode_linear_bytes(1) + self.decode_kv_bytes(context_len, 1)

    def decode_io_bytes(self) -> int:
        """Input/output vector traffic between processor and PIM per token."""
        # q/k/v/attn-out/ffn vectors, both directions, per layer (INT8)
        return self.n_layers * self.d_model * 8

    # ---- prefill ----------------------------------------------------------
    def prefill_flops(self, lin: int) -> float:
        """GEMM FLOPs for a length-`lin` prompt (2·N·L + attention term)."""
        linear = 2.0 * (self.linear_params + self.vocab * self.d_model) * lin
        attn = 2.0 * 2 * self.n_layers * self.d_model * lin * lin / 2  # causal
        return linear + attn

    def prefill_bytes(self, lin: int, wbytes: int = 2) -> float:
        acts = 2.0 * self.n_layers * lin * self.d_model * 6 * 2
        return self.linear_params * wbytes + acts


# The paper's "LLAMA-1B" matches the TinyLlama/LLaMA-3.2-1B scale class;
# 7B/13B are LLaMA v1 [36] configs.
LLAMA_1B = LLMSpec("llama-1b", n_layers=22, d_model=2048, n_heads=32, d_ff=5632)
LLAMA_7B = LLMSpec("llama-7b", n_layers=32, d_model=4096, n_heads=32, d_ff=11008)
LLAMA_13B = LLMSpec("llama-13b", n_layers=40, d_model=5120, n_heads=40, d_ff=13824)

MODELS = {m.name: m for m in (LLAMA_1B, LLAMA_7B, LLAMA_13B)}

"""Model configuration: the port's own copy of ``repro.configs.base.ModelConfig``.

The field set is the JAX package's, field for field, so a config round-trips
between the two packages with ``dataclasses.asdict``. Input-shape specs and
dry-run stand-ins (which use JAX) are not part of the port.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per assigned arch (plus smoke)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads

    # --- attention details ------------------------------------------------
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    local_global_pattern: bool = False
    post_block_norm: bool = False
    attn_scale_override: Optional[float] = None

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_group_size: int = 4096
    moe_capacity_factor: float = 1.25

    # --- SSM / RWKV ---------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0

    # --- encoder-decoder / multimodal ----------------------------------------
    n_encoder_layers: int = 0
    frontend: Optional[str] = None
    n_prefix_tokens: int = 0

    # --- decode backend dispatch (core/dispatch.py) ---------------------------
    attn_backend: str = "auto"        # auto: the CUDA kernel for CUDA tensors,
    #                                   the plain version for CPU tensors;
    #                                   reference: the plain version (CPU only)
    gemv_backend: str = ""            # JAX package's per-op override; the port's
    #                                   GEMV follows attn_backend
    decode_block_l: int = 512
    decode_kv_splits: int = 1         # paged decode: KV-split fan-out (1 = single pass)
    quantized_decode: bool = False    # W8A8 PIM-GEMV for decode-time qkv/o/MLP
    quant_decode_max_batch: int = 8   # largest GEMV batch routed to W8A8

    # --- serving --------------------------------------------------------------
    eos_id: Optional[int] = None

    # --- misc -----------------------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    kv_dtype: str = ""
    q_chunk: int = 1024
    causal_block_skip: bool = True
    seq_parallel: bool = False
    windowed_kv_cache: bool = False
    remat: bool = True
    scan_layers: bool = True

    # --- provenance ------------------------------------------------------------
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def token_coupled(self) -> bool:
        """True when a token's arithmetic depends on the other tokens of its
        forward: the MoE capacity dispatch drops the picks past an expert's
        capacity among the tokens of one call. Such a config is served with
        the JAX engine's grouping (one forward per admission chunk, one ragged
        prefill per batch-admission group), never cut into sub-steps."""
        return self.n_experts > 0

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, "ArchEntry"] = {}


@dataclass
class ArchEntry:
    config: ModelConfig
    smoke: ModelConfig


def register(full: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[full.name] = ArchEntry(config=full, smoke=smoke)
    return full


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers arch module imports)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    entry = _REGISTRY[name]
    return entry.smoke if smoke else entry.config


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)

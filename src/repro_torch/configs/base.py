"""Model configuration: the port's own copy of ``repro.configs.base.ModelConfig``.

The field set is the JAX package's, field for field, so a config round-trips
between the two packages with ``dataclasses.asdict``. The assigned
input-shape cells (:data:`SHAPES`, :func:`shape_applicable`,
:func:`all_cells`) are the JAX package's; :func:`input_specs` gives the stand-in
of each model input as a tensor on the ``meta`` device (shape and dtype, no
storage) where the JAX package gives a ``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch


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
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """long_500k requires sub-quadratic sequence mixing."""
        return self.family in ("ssm", "hybrid")

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

    # -- parameter count (for MODEL_FLOPS = 6 N D roofline term) -------------
    def param_count(self, active_only: bool = False) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        dense_mlp = 3 * d * f
        n = 0
        if self.family in ("dense", "vlm"):
            n = self.n_layers * (attn + dense_mlp)
        elif self.family == "moe":
            e = self.top_k if active_only else self.n_experts
            n = self.n_layers * (attn + 3 * d * f * e + d * self.n_experts)
        elif self.family == "ssm":  # rwkv6
            d_att = d
            tmix = 5 * d * d_att + d_att * d  # r,k,v,w,g projections + out
            cmix = 2 * d * f  # rwkv channel-mix has k,v (+r gate ~ d*d)
            n = self.n_layers * (tmix + cmix + d * d)
        elif self.family == "hybrid":
            d_in = self.ssm_expand * d
            ssm_block = d * 2 * d_in + d_in * d + d_in * (2 * self.ssm_state)
            n = self.n_layers * ssm_block + (attn + dense_mlp)  # shared attn once
        elif self.family == "audio":
            enc = self.n_encoder_layers * (attn + dense_mlp)
            dec = self.n_layers * (attn * 2 + dense_mlp)  # self + cross attn
            n = enc + dec
        n += v * d * (1 if self.tie_embeddings else 2)
        return n


# ---------------------------------------------------------------------------
# Input-shape specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned (seq_len, global_batch) input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, spec: ShapeSpec) -> tuple[bool, str]:
    """Whether the (arch, shape) cell runs, and the reason when it does not."""
    if spec.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} is full-attention (skip per assignment rules)"
        )
    return True, ""


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, spec: ShapeSpec) -> dict[str, torch.Tensor]:
    """``meta``-device stand-ins (shape and dtype, no storage) for every model
    input, with the JAX package's keys, shapes and dtypes:

    train:   {tokens, labels[, prefix_embeds | src_frames]}
    prefill: {tokens[, prefix_embeds | src_frames]}
    decode:  {tokens(B,1)}  (the cache is built separately)
    """
    b, s = spec.global_batch, spec.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    out: dict[str, torch.Tensor] = {}
    if spec.kind == "train":
        if cfg.family == "audio":
            out["src_frames"] = _meta((b, s // 2, cfg.d_model), bf16)
            out["tokens"] = _meta((b, s // 2), i32)
            out["labels"] = _meta((b, s // 2), i32)
        else:
            out["tokens"] = _meta((b, s), i32)
            out["labels"] = _meta((b, s), i32)
            if cfg.family == "vlm":
                out["prefix_embeds"] = _meta((b, cfg.n_prefix_tokens, cfg.d_model), bf16)
    elif spec.kind == "prefill":
        if cfg.family == "audio":
            out["src_frames"] = _meta((b, s, cfg.d_model), bf16)
            out["tokens"] = _meta((b, 1), i32)
        else:
            out["tokens"] = _meta((b, s), i32)
            if cfg.family == "vlm":
                out["prefix_embeds"] = _meta((b, cfg.n_prefix_tokens, cfg.d_model), bf16)
    else:  # decode: one new token against a cache of length seq_len
        out["tokens"] = _meta((b, 1), i32)
    return out


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


def all_cells() -> list[tuple[str, str, bool, str]]:
    """(arch, shape, applicable, reason) for the full 40-cell matrix."""
    cells = []
    for arch in list_archs():
        cfg = get_config(arch)
        for sname, spec in SHAPES.items():
            ok, why = shape_applicable(cfg, spec)
            cells.append((arch, sname, ok, why))
    return cells

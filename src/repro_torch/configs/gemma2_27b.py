"""gemma2-27b — local/global alternating attention, logit softcaps [arXiv:2408.00118]."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=36864,
    vocab_size=256000,
    rope_theta=10000.0,
    attn_softcap=50.0,
    logit_softcap=30.0,
    sliding_window=4096,
    local_global_pattern=True,
    post_block_norm=True,
    tie_embeddings=True,
    # gemma2-27b query_pre_attn_scalar = d_model / n_heads = 144
    attn_scale_override=144.0**-0.5,
    source="arXiv:2408.00118",
)

SMOKE = FULL.replace(
    name="gemma2-27b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    sliding_window=8,
    attn_scale_override=16.0**-0.5,
    q_chunk=8,
    remat=False,
)

register(FULL, SMOKE)

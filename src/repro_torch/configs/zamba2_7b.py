"""zamba2-7b — Mamba2 backbone + shared attention block [arXiv:2411.15242].

81 Mamba2 layers; ONE shared attention+MLP block (weight-shared, Zamba scheme)
applied after every 6 Mamba layers (13 applications). As in the JAX package,
the shared block consumes the running hidden state directly (no
concat-with-embedding LoRA).
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    source="arXiv:2411.15242",
)

SMOKE = FULL.replace(
    name="zamba2-7b-smoke",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=8,
    attn_every=2,
    q_chunk=8,
    remat=False,
)

register(FULL, SMOKE)

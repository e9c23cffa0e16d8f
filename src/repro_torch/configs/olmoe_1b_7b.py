"""olmoe-1b-7b — 64-expert top-8 MoE [arXiv:2409.02060]."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,  # per-expert FFN width
    vocab_size=50304,
    n_experts=64,
    top_k=8,
    source="arXiv:2409.02060",
)

SMOKE = FULL.replace(
    name="olmoe-1b-7b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=32,
    vocab_size=256,
    n_experts=8,
    top_k=2,
    moe_group_size=64,
    moe_capacity_factor=2.0,
    q_chunk=8,
    remat=False,
)

register(FULL, SMOKE)

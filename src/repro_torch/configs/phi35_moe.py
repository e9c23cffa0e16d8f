"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE [hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,  # per-expert FFN width
    vocab_size=32064,
    n_experts=16,
    top_k=2,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)

SMOKE = FULL.replace(
    name="phi3.5-moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=32,
    vocab_size=256,
    n_experts=4,
    top_k=2,
    moe_group_size=64,
    moe_capacity_factor=2.0,
    q_chunk=8,
    remat=False,
)

register(FULL, SMOKE)

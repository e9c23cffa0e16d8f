"""llama3-8b — dense GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    source="arXiv:2407.21783",
)

SMOKE = FULL.replace(
    name="llama3-8b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    q_chunk=8,
    remat=False,
)

register(FULL, SMOKE)

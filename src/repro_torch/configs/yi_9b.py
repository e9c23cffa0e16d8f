"""yi-9b — deep-narrow llama-arch, GQA kv=4 [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5000000.0,
    source="arXiv:2403.04652",
)

SMOKE = FULL.replace(
    name="yi-9b-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    q_chunk=8,
    remat=False,
)

register(FULL, SMOKE)

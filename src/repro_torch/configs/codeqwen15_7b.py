"""codeqwen1.5-7b — qwen1.5-arch dense, QKV bias, GQA kv=32 [hf:Qwen/CodeQwen1.5-7B]."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    rope_theta=1000000.0,
    qkv_bias=True,
    source="hf:Qwen/CodeQwen1.5-7B",
)

SMOKE = FULL.replace(
    name="codeqwen1.5-7b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    q_chunk=8,
    remat=False,
)

register(FULL, SMOKE)

"""rwkv6-1.6b 'Finch' — attention-free, data-dependent decay [arXiv:2404.05892].

Its decode state is recurrent only (the per-head wkv matrix and the two
token-shift tails): no KV cache, so the paper's K-col/V-row mapping does not
apply, and its projections stay plain matmuls (``ServingModel.prepare``
turns W8A8 off for the ``ssm`` family, as in the JAX package).
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # d_model / 64 wkv heads
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    source="arXiv:2404.05892",
)

SMOKE = FULL.replace(
    name="rwkv6-1.6b-smoke",
    n_layers=2,
    d_model=128,  # must be a multiple of the 64-wide wkv head
    n_heads=2,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=256,
    remat=False,
)

register(FULL, SMOKE)
